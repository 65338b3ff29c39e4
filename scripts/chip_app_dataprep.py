#!/usr/bin/env python3
"""The analyze, app and data-prep phases of chip_smoke.py alone on one CUDA
card: the reference's three winners with softened heads (random weights
from seeds 0-2) and the 32-frame 704 px pullback are made first, then
``analyze_path``, ``app_path`` and ``data_prep_path`` run as in
chip_smoke.py. Prints the card line, then one JSON line of the three
records.

Usage: python3 scripts/chip_app_dataprep.py   (from the repository root)
"""

import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from octseg_torch.data import dicom  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    tmp = tempfile.mkdtemp(prefix='octseg_torch_app_dataprep_')
    phases = chip_smoke.Phases()
    try:
        models = chip_smoke.make_ensemble(os.path.join(tmp, 'soft'))
        chip_smoke.soften_heads(models)
        dcm = os.path.join(tmp, 'IMG001')
        dicom.dcmwrite(dcm, chip_smoke.synthetic_pullback(chip_smoke.MAIN_FRAMES,
                                                          chip_smoke.MAIN_FRAME_PX, 0))
        main_path = {'dcm': dcm}
        out = {'analyze': phases.run('analyze', chip_smoke.analyze_path, tmp, main_path, models),
               'app': phases.run('app', chip_smoke.app_path, tmp, main_path, models),
               'data_prep': phases.run('data prep', chip_smoke.data_prep_path, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
