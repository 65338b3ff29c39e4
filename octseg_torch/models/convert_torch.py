"""Reference checkpoints -> port model dirs: octseg/models/convert_torch.py.

The reference trains SMP models and ships model dirs of ``config.json`` and
a torch ``weights.ckpt``: a Lightning checkpoint whose ``state_dict`` holds
``model.encoder.*``, ``model.decoder.*``, ``model.segmentation_head.*`` and
SMP's ``mean``/``std`` preprocessing buffers, or a bare SMP state dict.
``convert_reference_model_dir`` turns such a dir into a model dir the port
(and octseg) loads: ``weights.ckpt`` in the shared flax msgpack layout,
byte-equal to what octseg's converter writes, and the same ``config.json``.

The port's module names are SMP's (models/convert.py), so the state dict,
with the ``model.`` prefix stripped and the buffers dropped, is checked key
by key and shape by shape against the model built on the meta device, and
``state_dict_to_variables`` writes it out.

One deviation from octseg: the file is read with
``torch.load(weights_only=True)``. A Lightning checkpoint of plain types
(optimizer and scheduler states, callbacks, hyper-parameters, epoch, step)
loads; where torch refuses a global, its error names it, and there is no
retry with ``weights_only=False``.

    python -m octseg_torch.models.convert_torch <torch_model_dir> <out_model_dir> \\
        [--input-size N]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

# SMP's preprocessing buffers, which no model of either package holds
_BUFFERS = ('mean', 'std')
# the encoder's classification tail per family, which octseg's converter
# drops without a word
_TAILS = {
    'resnet': ('fc.weight', 'fc.bias'),
    'timm-regnet': ('head.fc.weight', 'head.fc.bias'),
    'efficientnet': ('_conv_head.weight', '_bn1.weight', '_bn1.bias', '_bn1.running_mean',
                     '_bn1.running_var', '_fc.weight', '_fc.bias'),
}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file -> {name: np.ndarray}: a Lightning checkpoint's
    ``state_dict``, or the file's dict itself (a bare state dict)."""
    import torch

    raw = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'state_dict' in raw:
        raw = raw['state_dict']
    return {k: v.numpy() if hasattr(v, 'numpy') else np.asarray(v) for k, v in raw.items()}


def model_state_dict(sd: Dict[str, np.ndarray], architecture: str, encoder: str,
                     classes: int) -> Dict[str, np.ndarray]:
    """A reference state dict -> the port model's state dict, checked against
    the model built on the meta device. The ``model.`` prefix is stripped
    where any key has it; ``mean``/``std`` and the encoder's classification
    tail are dropped; each ``num_batches_tracked`` (of any shape, or none) is
    left out. Keys the model lacks are logged, as octseg logs its unconsumed
    keys, except a conv bias the model's conv has not, which octseg's
    converter takes and its shape check refuses. A missing or mismatched
    tensor raises ValueError listing the paths."""
    import torch

    from octseg_torch.models import create_model
    from octseg_torch.models.encoders import encoder_family

    tails = {f'encoder.{k}' for k in _TAILS[encoder_family(encoder)]}
    prefix = 'model.' if any(k.startswith('model.') for k in sd) else ''
    with torch.device('meta'):
        model = create_model(architecture, encoder, classes=classes)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, np.ndarray] = {}
    leftover: List[str] = []
    for key, value in sd.items():
        name = key[len(prefix):] if prefix and key.startswith(prefix) else key
        if name in _BUFFERS or name in tails or name.endswith('num_batches_tracked'):
            continue
        if name in own:
            out[name] = value
        else:
            leftover.append(key)
    errors = [f'missing {k}' for k in own
              if k not in out and not k.endswith('num_batches_tracked')]
    errors += [f'unexpected {prefix}{k}' for k in (key[len(prefix):] for key in leftover)
               if k.endswith('.bias') and k[:-len('bias')] + 'weight' in own]
    errors += [f'shape mismatch at {k}: got {tuple(np.shape(v))}, model wants {own[k]}'
               for k, v in out.items() if tuple(np.shape(v)) != own[k]]
    if errors:
        raise ValueError('converted tree does not match the model:\n  '
                         + '\n  '.join(errors[:20]))
    if leftover:
        log.warning('unconsumed torch keys: %s', leftover[:10])
    return out


def convert_reference_model_dir(torch_model_dir: str, out_model_dir: str,
                                input_size: Optional[int] = None) -> str:
    """A reference model dir (config.json + torch weights.ckpt) -> a model
    dir of the same contract in the shared layout. ``input_size`` overrides
    the manifest's and is written into the emitted config.json; with neither
    this raises ValueError. Returns ``out_model_dir``."""
    from octseg_torch.models.convert import state_dict_to_variables
    from octseg_torch.train.checkpoint import save_weights

    with open(os.path.join(torch_model_dir, 'config.json')) as f:
        cfg = json.load(f)
    sd = load_torch_state_dict(os.path.join(torch_model_dir, 'weights.ckpt'))
    if input_size is not None:
        cfg['input_size'] = int(input_size)   # the emitted manifest must agree
    elif 'input_size' not in cfg:
        raise ValueError(
            f'{torch_model_dir}/config.json has no input_size — pass '
            f'--input-size (it is written into the converted manifest)')
    arch, encoder = cfg['architecture'], cfg['encoder']
    sd = model_state_dict(sd, arch, encoder, len(cfg['classes']))
    variables = state_dict_to_variables(sd, arch, encoder)
    os.makedirs(out_model_dir, exist_ok=True)
    save_weights(os.path.join(out_model_dir, 'weights.ckpt'),
                 variables['params'], variables['batch_stats'])
    with open(os.path.join(out_model_dir, 'config.json'), 'w') as f:
        json.dump(cfg, f, indent=2)
    log.info('converted %s -> %s', torch_model_dir, out_model_dir)
    return out_model_dir


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: convert a reference model dir into a port model dir; prints the
    output dir."""
    parser = argparse.ArgumentParser(
        description='Convert a reference (torch/SMP) model dir to a port model dir.')
    parser.add_argument('torch_model_dir',
                        help='reference model dir (config.json + weights.ckpt)')
    parser.add_argument('out_model_dir', help='output model dir')
    parser.add_argument('--input-size', type=int, default=None,
                        help='override config.json input_size (also written into the '
                             'emitted config.json)')
    args = parser.parse_args(argv)
    print(convert_reference_model_dir(args.torch_model_dir, args.out_model_dir,
                                      input_size=args.input_size))


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main()
