"""Binary-mask bitpacking for the device-to-host copy (octseg/ops/bitpack.py).

Masks are packed 8 pixels per byte along W on the device, big-endian within
a byte (``np.unpackbits(..., bitorder='big')`` order), and the host expands
and routes them with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) {0,1} (uint8 or bool) -> (N, H, ceil(W/8), C) uint8."""
    m = masks.permute(0, 1, 3, 2).to(torch.uint8)  # W last
    pad = (-m.shape[-1]) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(*m.shape[:-1], m.shape[-1] // 8, 8)
    w = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=m.device)
    # disjoint bit weights: the sum never exceeds 255
    return (m * w).sum(dim=-1, dtype=torch.uint8).permute(0, 1, 3, 2)


def unpack_mask_bits(packed: np.ndarray, out_w: int) -> np.ndarray:
    """Host inverse: (N, H, ceil(W/8), C) uint8 -> (N, H, out_w, C) {0,1}."""
    return np.unpackbits(np.ascontiguousarray(packed), axis=2, count=int(out_w))


def unpack_route_into(packed: np.ndarray, out: np.ndarray, routes) -> None:
    """out[..., dst] = bits[..., src] for each (src, dst) in ``routes``;
    packed is (N, H, ceil(W/8), Cs), out (N, H, W, OC) float32."""
    pred = unpack_mask_bits(packed, out.shape[2])
    for src, dst in routes:
        out[:, :, :, dst] = pred[:, :, :, src]
