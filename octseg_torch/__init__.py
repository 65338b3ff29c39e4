"""octseg_torch — the PyTorch/CUDA port of octseg for one NVIDIA H100.

Mirrors the module layout of the JAX package ``octseg`` (its reference),
module for module. At runtime it imports torch, numpy and the standard
library only. Entry points run on ``cuda`` unless the caller passes
``device='cpu'``; without a GPU and without that request they raise.
"""

import os
from typing import List

import torch

__version__ = '0.1.0'

# Repository root (parent of this package): configs/ and relative paths in
# entry-point configs resolve against it, as in octseg.PROJECT_DIR.
PROJECT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def project_path(path: str) -> str:
    """``path``, or for a relative one the path under PROJECT_DIR, as the
    entry points read the paths of their configs."""
    return path if os.path.isabs(path) else os.path.join(PROJECT_DIR, path)


def resolve_device(device=None) -> torch.device:
    """``None`` / ``'auto'`` / ``'cuda'`` -> the GPU, raising when there is
    none; ``'cpu'`` (what the tests pass) -> the CPU."""
    if device is None or str(device) == 'auto':
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'octseg_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run on the CPU")
    return device


def device_pool(device=None) -> List[torch.device]:
    """The devices independent jobs (folds, tuning trials) may take, one
    each: every CUDA device for ``None``, ``'auto'`` or ``'cuda'``, else the
    one device named (``resolve_device``'s rules)."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    return [device]
