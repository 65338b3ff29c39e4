#!/usr/bin/env python3
"""Why two predicts on the card are not bitwise equal, and what
deterministic algorithms cost.

Three modes: "default", the port as it is (cuDNN's default algorithm
choice everywhere); "transposed", ``models.common.ConvTranspose2d``'s
forward on cuDNN's deterministic algorithms, the rest default (the script
patches it in); "deterministic", ``torch.backends.cudnn.deterministic =
True`` everywhere. For each winner of the ensemble (chip_smoke.ENSEMBLE,
random weights from seeds 0-2, full width) the first 8 frames of
chip_smoke's synthetic pullback, resized as the engine's pullback forward
does, run through the model twice in each mode (TF32 off, as the engine
runs), a forward hook on every module checksumming its output's bits; the
first module whose outputs differ between two runs is reported with its
type. Then the engine itself: each model's 32-frame block through
``InferenceEngine.iter_pullback`` (after the probe), the modes in turns
(default, transposed, deterministic, then the reverse, twice), seconds
per block and the mask pixels that differ between two runs of a mode;
last the ensemble's 32-frame block (all three models, predict.yaml's four
classes, as predict runs it) in the default and transposed modes in turns
(default, transposed, transposed, default, ENSEMBLE_ROUNDS times).
Prints the card line and one JSON line; with CHIP_SMOKE_RECORDS set, also
writes it to that file.

Usage: python3 scripts/chip_repeatability.py   (from the repository root)
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from octseg_torch.models import common  # noqa: E402
from octseg_torch.infer.engine import InferenceEngine, fp32_exact, load_model_bundle  # noqa: E402
from octseg_torch.ops.resize import resize_bilinear_nchw  # noqa: E402

FRAMES = 32
HOOKED_FRAMES = 8     # the checksummed forwards run on the block's first 8 frames
ROUNDS = 2
ENSEMBLE_ROUNDS = 4
MODES = ('default', 'transposed', 'deterministic')


def deterministic_transposed(self, x):
    """ConvTranspose2d's forward on cuDNN's deterministic algorithms."""
    x, w, b = self.cast(x)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=True,
                     allow_tf32=cudnn.allow_tf32):
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


@contextlib.contextmanager
def mode(name):
    port_forward = common.ConvTranspose2d.forward
    if name == 'transposed':
        common.ConvTranspose2d.forward = deterministic_transposed
    torch.backends.cudnn.deterministic = name == 'deterministic'
    try:
        yield
    finally:
        common.ConvTranspose2d.forward = port_forward
        torch.backends.cudnn.deterministic = False


def checksums(model, x):
    """[(module name, type, checksum)] in the order the modules return."""
    out = []
    names = {m: n for n, m in model.named_modules()}

    def hook(mod, _args, y):
        if isinstance(y, torch.Tensor) and y.is_floating_point():
            bits = y.detach().contiguous().view(-1).view(torch.int32).long()
            out.append((names[mod], type(mod).__name__,
                        (int(bits.sum()), int((bits * bits).sum()))))

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.inference_mode(), fp32_exact():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return out


def first_difference(a, b):
    for (name, kind, ha), (_n, _k, hb) in zip(a, b):
        if ha != hb:
            return {'module': name, 'type': kind}
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix='octseg_repeat_')
    record = {'card': card, 'frames': FRAMES, 'models': {}}
    try:
        models = chip_smoke.make_ensemble(os.path.join(tmp, 'models'))
        frames = chip_smoke.synthetic_pullback(FRAMES, chip_smoke.MAIN_FRAME_PX, 0)[..., None]
        raw = torch.from_numpy(frames).cuda().float().permute(0, 3, 1, 2)
        for name, classes, arch, encoder, size in chip_smoke.ENSEMBLE:
            model, _cfg = load_model_bundle(os.path.join(models, name), 'cuda')
            x = resize_bilinear_nchw(raw[:HOOKED_FRAMES], (size, size)).expand(-1, 3, -1, -1)
            x = x.contiguous()
            rec = {'model': f'{arch}/{encoder}', 'input_size': size}
            for key in MODES:
                with mode(key):
                    runs = [checksums(model, x) for _ in range(2)]
                rec[key] = {'modules': len(runs[0]),
                            'first_difference': first_difference(*runs),
                            'differing_modules': sum(a[2] != b[2] for a, b in zip(*runs))}
            del model, x
            torch.cuda.empty_cache()
            # the engine's block, default and deterministic in turns
            engine = InferenceEngine(models, classes, block_size=FRAMES, device='cuda')
            list(engine.iter_pullback(frames, (chip_smoke.MAIN_OUT, chip_smoke.MAIN_OUT)))
            seconds = {key: [] for key in MODES}
            first, differing = {}, {key: 0 for key in MODES}
            for _ in range(ROUNDS):
                for key in MODES + MODES[::-1]:
                    with mode(key):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        got = [m for _s, m in engine.iter_pullback(
                            frames, (chip_smoke.MAIN_OUT, chip_smoke.MAIN_OUT))][0]
                        seconds[key].append(time.perf_counter() - t)
                    if key in first:
                        differing[key] = max(differing[key], int((got != first[key]).sum()))
                    else:
                        first[key] = got
            rec['engine_block_s'] = seconds
            rec['engine_median_s'] = {k: float(np.median(v)) for k, v in seconds.items()}
            rec['engine_cost_over_default'] = {
                k: rec['engine_median_s'][k] / rec['engine_median_s']['default'] - 1
                for k in MODES[1:]}
            rec['mask_px_differing_between_runs'] = differing
            record['models'][name] = rec
            print(json.dumps({name: rec}), file=sys.stderr, flush=True)
            del engine, first
            torch.cuda.empty_cache()
        classes = [c for _n, cls, *_ in chip_smoke.ENSEMBLE for c in cls]
        engine = InferenceEngine(models, classes, block_size=FRAMES, device='cuda')
        list(engine.iter_pullback(frames, (chip_smoke.MAIN_OUT, chip_smoke.MAIN_OUT)))
        seconds = {'default': [], 'transposed': []}
        for _ in range(ENSEMBLE_ROUNDS):
            for key in ('default', 'transposed', 'transposed', 'default'):
                with mode(key):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    list(engine.iter_pullback(frames, (chip_smoke.MAIN_OUT, chip_smoke.MAIN_OUT)))
                    seconds[key].append(time.perf_counter() - t)
        median = {k: float(np.median(v)) for k, v in seconds.items()}
        record['ensemble'] = {'block_s': seconds, 'median_s': median,
                              'transposed_cost_over_default':
                                  median['transposed'] / median['default'] - 1}
        print(json.dumps({'ensemble': record['ensemble']}), file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
