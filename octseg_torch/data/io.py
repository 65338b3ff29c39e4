"""Host image IO (the port of octseg/data/io.py): PNG and JPEG frames as
``cv2.imread``/``cv2.imwrite`` read and write them, and the (H, W, C) mask
TIFFs of octseg's own codec.

``imread`` is ``data/image.py``'s ``read_png`` (BGR, as cv2 gives it),
``imwrite`` writes the PNG without cv2, at cv2's default zlib level 1: the
array is taken as BGR (three channels) or BGRA (four) and stored as RGB(A),
so the file decodes to the pixels cv2 would have written (the bytes differ:
cv2 filters its own way).
"""

from __future__ import annotations

import os

import numpy as np

from octseg_torch.data import tiffio
from octseg_torch.data.image import encode_png, read_png


def imread(path: str, bgr: bool = True) -> np.ndarray:
    """Read a PNG or JPEG to uint8 (H, W, 3): BGR by default, RGB with
    ``bgr=False``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f'Cannot read image: {path}')
    img = read_png(path)
    return img if bgr else np.ascontiguousarray(img[..., ::-1])


def imwrite(path: str, img: np.ndarray, bgr: bool = True) -> None:
    """Write uint8 (H, W), (H, W, 3) or (H, W, 4) as a PNG; a colour image
    is BGR(A) unless ``bgr=False`` says it is RGB(A)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if img.ndim == 3 and bgr:
        order = [2, 1, 0] + ([3] if img.shape[2] == 4 else [])
        img = img[..., order]
    with open(path, 'wb') as f:
        f.write(encode_png(np.ascontiguousarray(img), level=1))   # cv2's default level


def imread_mask_tiff(path: str) -> np.ndarray:
    """Read an (H, W, C) uint8 mask TIFF (values {0, 255} per class channel)."""
    return tiffio.read_tiff(path)


def imwrite_mask_tiff(path: str, mask: np.ndarray, compression: str = 'lzw') -> None:
    """Write an (H, W, C) uint8 mask TIFF, LZW compressed by default."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tiffio.write_tiff(path, mask.astype(np.uint8), compression=compression)
