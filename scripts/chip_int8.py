#!/usr/bin/env python3
"""The int8 kernels alone on one CUDA card: chip_smoke.py's "int8 kernels"
check (K5 and K4 against their plain versions, bit for bit, on every
distinct eligible convolution call of the three winners and the extra
cases, then timed beside their bounds, plain versions and yardsticks) and
its int8 logits GPU against CPU at 64 px, without the rest of
chip_smoke.py. Prints the card line, then one JSON line; with
CHIP_SMOKE_RECORDS set, also writes it to that file.

Usage: python3 scripts/chip_int8.py   (from the repository root)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from octseg_torch.ops.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    t = time.perf_counter()
    _build.load('quantize')
    _build.load('int8_conv')
    record = {'card': card, 'build_s': time.perf_counter() - t}
    t = time.perf_counter()
    record['int8_kernels'] = chip_smoke.check_int8_kernels(torch)
    record['int8_kernels_s'] = time.perf_counter() - t
    t = time.perf_counter()
    record['int8_logits_gpu_vs_cpu'] = chip_smoke.int8_logits_gpu_vs_cpu()
    record['int8_logits_s'] = time.perf_counter() - t
    line = json.dumps(record)
    path = os.environ.get('CHIP_SMOKE_RECORDS')
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            f.write(line)
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
