"""Scalar logging (the port of ScalarLogger in octseg/core/logging_utils.py).

Scalars go to stdout through ``logging`` and to an append-only
``scalars.jsonl`` in the run directory.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

log = logging.getLogger(__name__)


class ScalarLogger:
    """Scalar sink: stdout (via logging) + ``{run_dir}/scalars.jsonl``."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.jsonl_path = os.path.join(run_dir, 'scalars.jsonl')

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        record = {'step': step, **{k: float(v) for k, v in scalars.items()}}
        parts = '  '.join(f'{k} {v:.4f}' for k, v in record.items() if k != 'step')
        log.info('step %d  %s', step, parts)
        with open(self.jsonl_path, 'a') as f:
            f.write(json.dumps(record) + '\n')
