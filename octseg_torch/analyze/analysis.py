"""Quantification engine: per-frame plaque features over a pullback.

The port of ``octseg/analyze/analysis.py``: the numeric core
(``calculate_thickness_contour``, ``quantify_frame``,
``calculate_object_thickness``), with the same outputs as Python floats on
the same masks, and the analyze app's analysis:

- ``_run_inference_into``: a DICOM -> per-frame min-max normalisation ->
  viewer PNGs -> the ensemble through ``InferenceEngine.iter_pullback`` on
  the card -> one mask TIFF per frame in the work dir (grayscale DICOMs stay
  single-channel through the engine, as octseg's mono path);
- ``frame_contours``: one frame's object polygons (external contours
  reduced by ``approxPolyDP(0.7, closed)``) with the hover fields;
- ``get_analysis``: demo mode over an existing work dir, or inference mode;
  per frame and class object tracking by slice continuity, area and
  thickness, and each class mask as a base64 PNG (the port's own PNG bytes,
  which decode to octseg's pixels).

Contours come from ``analyze/contours.py`` (cv2's ``findContours``,
``contourArea`` and ``moments`` without cv2), the tracer from its host C++
build unless ``native=False`` (``approxPolyDP`` too, with data/draw.py's
``approx_poly_dp`` as its plain version).
"""

from __future__ import annotations

import base64
import os
import uuid
from glob import glob
from typing import Any, Dict, List, Optional

import numpy as np

from octseg_torch.analyze.contours import (approx_polygons, contour_areas, contour_moments,
                                           find_external_contours)
from octseg_torch.core.registry import CLASS_COLORS_RGB, CLASS_IDS, CLASS_IDS_REVERSED
from octseg_torch.data import dicom
from octseg_torch.data.image import encode_png, normalize_slice, write_png
from octseg_torch.data.tiffio import read_tiff, write_tiff

# cv2 5.0's fixed-point BGR -> gray for uint8: 0.114, 0.587 and 0.299 in 15
# bits, rounded half up (equal to cv2 on all 2**24 colours)
_GRAY_SHIFT = 15
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798


def bgr_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` for (H, W, 3) uint8."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected (H, W, 3) uint8, got {img.shape} {img.dtype}')
    c = img.astype(np.int32)
    y = c[..., 0] * _B2Y + c[..., 1] * _G2Y + c[..., 2] * _R2Y + (1 << (_GRAY_SHIFT - 1))
    return (y >> _GRAY_SHIFT).astype(np.uint8)


def calculate_thickness_contour(mask: np.ndarray, native: bool = True) -> Dict[str, Any]:
    """Median/min/max distance from the largest contour to its centroid."""
    empty = {'median': 0, 'min': 0, 'max': 0, 'all_measurements': []}
    contours = find_external_contours(mask, native=native)
    if not contours:
        return empty
    # the first of equal areas, as max(contours, key=cv2.contourArea) picks
    contour = contours[int(np.argmax(contour_areas(contours)))]
    m = contour_moments(contour)
    if m['m00'] == 0:
        return empty
    cx = int(m['m10'] / m['m00'])
    cy = int(m['m01'] / m['m00'])
    pts = contour.reshape(-1, 2).astype(np.float64)
    distances = np.sqrt((pts[:, 0] - cx) ** 2 + (pts[:, 1] - cy) ** 2)
    return {
        'median': float(np.median(distances)),
        'min': float(np.min(distances)),
        'max': float(np.max(distances)),
        'all_measurements': distances.tolist(),
    }


def quantify_frame(channel: np.ndarray, ratio: int, native: bool = True) -> Dict[str, float]:
    """One frame x one class: area = sqrt(nonzero px // ratio), thickness
    median/min of contour-point distances to the contour centroid, scaled
    by ratio. ``channel`` is a binary (H, W) uint8 mask."""
    thickness = calculate_thickness_contour(channel, native=native)
    return {
        'area': pow(int(np.count_nonzero(channel)) // ratio, 0.5),
        'thickness_mean': thickness['median'] / ratio,
        'thickness_min': thickness['min'] / ratio,
    }


def calculate_object_thickness(mask: np.ndarray) -> Dict[str, Any]:
    """360-degree ray march from the image centre: per degree, the outermost
    radius of the first contiguous run of 255 pixels. A 3-channel uint8
    mask is made gray first, as ``cv2.cvtColor(BGR2GRAY)`` rounds it."""
    if mask.ndim > 2:
        mask = bgr_to_gray_u8(mask)
    height, width = mask.shape
    cx, cy = width // 2, height // 2
    max_radius = int(np.sqrt(width**2 + height**2)) // 2

    angles = np.deg2rad(np.arange(0, 360))[:, None]  # (360, 1)
    rs = np.arange(1, max_radius)[None, :]  # (1, R)
    xs = (cx + rs * np.cos(angles)).astype(np.int32)
    ys = (cy + rs * np.sin(angles)).astype(np.int32)
    inbounds = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    vals = np.where(
        inbounds, mask[np.clip(ys, 0, height - 1), np.clip(xs, 0, width - 1)], 0
    )
    on = vals == 255
    # walk outward, remember the last object pixel, stop at the first
    # off-pixel after having been inside the object (or at the border)
    radii: List[int] = []
    for row_on, row_in in zip(on, inbounds):
        current, found = 0, False
        for r_idx in range(row_on.shape[0]):
            if not row_in[r_idx]:
                break
            if row_on[r_idx]:
                current = r_idx + 1
                found = True
            elif found:
                break
        if found:
            radii.append(current)
    if not radii:
        return {'median': 0, 'min': 0, 'max': 0, 'all_measurements': []}
    return {
        'median': float(np.median(radii)),
        'min': float(np.min(radii)),
        'max': float(np.max(radii)),
        'all_measurements': radii,
    }


def _run_inference_into(work_dir: str, dcm_path: str, models_dir: str,
                        classes: List[str], device=None) -> None:
    """Inference mode: DICOM -> frames -> ensemble masks in ``work_dir``
    (``img/frame_NNN.png`` viewer frames, ``mask/frame_NNN.tiff`` (H, W, 4)
    {0, 255} masks at the frame size)."""
    from octseg_torch.infer.engine import InferenceEngine, fp32_exact

    frames = dicom.dcmread(dcm_path).pixel_array
    # a grayscale DICOM stays single-channel: (N, H, W, 1) goes to the
    # engine's mono path; only the viewer PNGs are replicated to RGB
    mono = frames.ndim == 3
    os.makedirs(os.path.join(work_dir, 'img'), exist_ok=True)
    os.makedirs(os.path.join(work_dir, 'mask'), exist_ok=True)
    h, w = frames.shape[1:3]
    norm = np.empty((*frames.shape[:3], 1 if mono else 3), np.uint8)
    for idx in range(frames.shape[0]):
        img = normalize_slice(frames[idx])
        norm[idx] = img[..., None] if mono else img
        # octseg writes cv2.cvtColor(img, BGR2RGB) with cv2.imwrite, which
        # stores the frame's own channel order
        write_png(os.path.join(work_dir, 'img', f'frame_{idx + 1:03d}.png'),
                  np.repeat(img[..., None], 3, axis=-1) if mono else img)
    engine = InferenceEngine(models_dir=models_dir, classes=classes, device=device)
    with fp32_exact():
        for start, block in engine.iter_pullback(norm, output_size=[h, w]):
            for j in range(block.shape[0]):
                write_tiff(os.path.join(work_dir, 'mask', f'frame_{start + j + 1:03d}.tiff'),
                           (block[j] * 255).astype(np.uint8))


def frame_contours(data: Dict[str, Any], img_num: int, classes: Optional[List[str]] = None,
                   native: bool = True) -> Dict[str, Any]:
    """Per-object contour polygons and hover fields of one frame (the JSON
    behind the app's viewer): for each class with pixels, its external
    contours reduced by ``approxPolyDP(contour, 0.7, True)`` (polygons of
    at least 3 points), its colour, and area and mean/min thickness from the
    analysis, rounded to 2 decimals."""
    classes = classes or list(CLASS_IDS)
    mask_paths = sorted(glob(f"{data['work_dir']}/mask/*.tiff"))
    out: Dict[str, Any] = {'width': 0, 'height': 0, 'objects': []}
    if img_num < 0 or img_num >= len(mask_paths):
        return out
    mask = read_tiff(mask_paths[img_num])
    if mask.ndim == 2:
        mask = mask[:, :, None]
    out['height'], out['width'] = mask.shape[:2]
    for class_name in classes:
        class_id = CLASS_IDS.get(class_name)
        if class_id is None or class_id - 1 >= mask.shape[2]:
            continue
        channel = mask[:, :, class_id - 1]
        if not np.any(channel):
            continue
        obj = data['objects'][class_name]
        area = thickness_mean = thickness_min = 0.0
        if img_num in obj['slice']:
            pos = obj['slice'].index(img_num)
            area = obj['area'][pos]
            thickness_mean = obj['thickness_mean'][pos]
            thickness_min = obj['thickness_min'][pos]
        polygons = [approx.reshape(-1, 2).tolist() for approx in approx_polygons(
            find_external_contours(channel, native=native), 0.7, True, native=native)
            if len(approx) >= 3]
        if polygons:
            out['objects'].append({
                'class': class_name,
                'color': list(CLASS_COLORS_RGB[class_name]),
                'area': round(float(area), 2),
                'thickness_mean': round(float(thickness_mean), 2),
                'thickness_min': round(float(thickness_min), 2),
                'polygons': polygons,
            })
    return out


def get_analysis(file: Optional[str], inference_type: str = 'demo',
                 demo_dir: str = 'data/app/demo', models_dir: str = 'models',
                 classes: Optional[List[str]] = None, temp_root: str = 'data/app/temp',
                 device=None) -> Dict[str, Any]:
    """Analyse a pullback: the JSON-able dict of the pixel-to-unit ratio
    (frame height * 150 // 1000), per-class object traces (area, mean and
    min thickness, slice, object id, base64 PNG mask, image name), the
    image names, and the work dir under 'work_dir'.

    Demo mode reads ``demo_dir`` (the ratio from ``file``'s DICOM if given,
    else from the first mask, else 1000 rows); inference mode runs
    ``_run_inference_into`` on ``file`` into a new dir under ``temp_root``
    on ``device`` (the GPU unless 'cpu')."""
    classes = classes or list(CLASS_IDS)
    if inference_type == 'demo':
        work_dir = demo_dir
        if file:
            slices_h = dicom.dcmread(file).pixel_array.shape[1]
        else:
            sample = sorted(glob(f'{work_dir}/mask/*.tiff'))
            slices_h = read_tiff(sample[0]).shape[0] if sample else 1000
    else:
        work_dir = os.path.join(temp_root, str(uuid.uuid4()))
        _run_inference_into(work_dir, file, models_dir, classes, device=device)
        slices_h = dicom.dcmread(file).pixel_array.shape[1]

    ratio = int(slices_h * 150 // 1000)
    objects: Dict[str, Dict[str, List[Any]]] = {
        class_name: {'area': [], 'thickness_mean': [], 'thickness_min': [], 'slice': [],
                     'object_id': [], 'masks': [], 'img_name': []}
        for class_name in CLASS_IDS
    }
    data: Dict[str, Any] = {'ratio': ratio, 'objects': objects, 'images': [],
                            'work_dir': work_dir}
    for idx, mask_path in enumerate(sorted(glob(f'{work_dir}/mask/*.tiff'))):
        mask = read_tiff(mask_path)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        name = os.path.basename(mask_path).split('.')[0]
        for class_id, class_name in CLASS_IDS_REVERSED.items():
            if class_id - 1 >= mask.shape[2]:
                continue
            channel = mask[:, :, class_id - 1]
            # exactly two distinct values (octseg: np.unique(channel).shape[0] == 2)
            if np.count_nonzero(np.bincount(channel.reshape(-1), minlength=256)) != 2:
                continue
            obj = objects[class_name]
            # instance tracking by slice continuity
            if not obj['object_id']:
                obj['object_id'].append(0)
            elif idx == obj['slice'][-1] + 1:
                obj['object_id'].append(obj['object_id'][-1])
            else:
                obj['object_id'].append(obj['object_id'][-1] + 1)
            obj['slice'].append(idx)
            q = quantify_frame(channel, ratio)
            obj['area'].append(q['area'])
            obj['thickness_mean'].append(q['thickness_mean'])
            obj['thickness_min'].append(q['thickness_min'])
            obj['masks'].append(base64.b64encode(encode_png(channel)).decode('utf-8'))
            obj['img_name'].append(name)
        data['images'].append(name)
    return data
