"""Class registry for the four OCT plaque features.

A copy of octseg/core/registry.py (the port imports nothing of octseg).
Channel convention: ``channel = class_id - 1`` in (H, W, 4) masks.
"""

from __future__ import annotations

CLASS_MAP = {
    'Lumen': {'id': 1, 'color': [228, 30, 199]},
    'Fibrous cap': {'id': 2, 'color': [123, 171, 226]},
    'Lipid core': {'id': 3, 'color': [125, 227, 127]},
    'Vasa vasorum': {'id': 4, 'color': [208, 2, 27]},
}

CLASS_COLORS_RGB = {name: tuple(info['color']) for name, info in CLASS_MAP.items()}

CLASS_IDS = {name: info['id'] for name, info in CLASS_MAP.items()}
