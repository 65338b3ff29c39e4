"""Model profiler: parameter and FLOP counts for any architecture x encoder
(the port of octseg/models/get_model_info.py).

- ``params``: the model's parameters, as octseg counts its flax ``params``
  tree. BatchNorm's running statistics are buffers here and ``batch_stats``
  there, and neither package counts them.
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over one eval
  forward of a (1, 3, input_size, input_size) input: convolutions and
  matmuls at 2 FLOPs per multiply-add. octseg reads XLA's ``cost_analysis``
  of the compiled forward, which also counts elementwise work (BatchNorm,
  activations, adds) and its bilinear resizes' interpolation matrices, so
  its count is the larger (PERF.md gives the band between the two).
- ``bytes_accessed``: None. XLA's figure is the traffic of the fused
  program it compiled; eager PyTorch runs no such program, and a sum of
  each operator's inputs and outputs would be another quantity under the
  same name.

Config: configs/get_model_info.yaml.
Usage: python -m octseg_torch.models.get_model_info [key=value ...];
``device=cpu`` off the card.
"""

from __future__ import annotations

import logging

import torch
from torch.utils.flop_counter import FlopCounterMode

import octseg_torch
from octseg_torch.core.config import Config, entry_point
from octseg_torch.models import create_model

log = logging.getLogger(__name__)


def model_info(architecture: str, encoder: str, input_size: int = 512, classes: int = 4,
               device=None) -> dict:
    device = octseg_torch.resolve_device(device)
    model = create_model(architecture, encoder, classes=classes).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((1, 3, input_size, input_size), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    flops = float(counter.get_total_flops())
    return {
        'architecture': architecture,
        'encoder': encoder,
        'input_size': input_size,
        'params': n_params,
        'params_m': round(n_params / 1e6, 2),
        'flops': flops,
        'gflops': round(flops / 1e9, 2),
        'bytes_accessed': None,
    }


@entry_point('get_model_info')
def main(cfg: Config) -> dict:
    info = model_info(cfg.architecture, cfg.encoder, int(cfg.get('input_size', 512)),
                      int(cfg.get('num_classes', 4)), cfg.get('device'))
    log.info('Model complexity:')
    for k, v in info.items():
        log.info('  %s: %s', k, v)
    return info


if __name__ == '__main__':
    main()
