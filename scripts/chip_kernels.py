#!/usr/bin/env python3
"""K1 and K2 alone on one CUDA card: chip_smoke.py's kernel checks (each
kernel against its plain torch version, then timed beside its bound, its
plain version and, for K2, F.grid_sample), twice, without the rest of
chip_smoke.py. Prints the card line, then one JSON line per pass.

Usage: python3 scripts/chip_kernels.py   (from the repository root)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from octseg_torch.ops.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    _build.load('postprocess')
    _build.load('warp')
    for run in range(2):
        k1 = chip_smoke.check_k1(torch)
        k2 = chip_smoke.check_k2(torch)
        print(json.dumps({
            'run': run,
            'k1': {k: k1[k] for k in ('ms', 'plain_ms', 'bound_ms', 'ms_32', 'ms_64')},
            'k2': {k: v for k, v in k2.items()
                   if k.startswith(('ms', 'plain_ms', 'library_ms', 'bound_ms'))}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
