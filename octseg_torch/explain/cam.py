"""Class activation maps: nine Grad-CAM-family methods (the port of
octseg/explain/cam.py).

The activations are one level of the model's feature pyramid
(``SegmentationModel.encode``; by default the deepest level the decoder
reads), and the gradients are ``torch.autograd.grad`` of the target through
``SegmentationModel.decode``, in eval mode, where octseg takes ``jax.grad``.
Everything after that is host numpy, as in octseg: the weights of each
method, EigenCAM's SVD, the percentile cap, then the resize to the image
through ``ops/resize.resize_bilinear`` (octseg's ``resize_bilinear``).

Methods: GradCAM, HiResCAM, GradCAMElementWise, GradCAM++, XGradCAM,
AblationCAM, EigenCAM, EigenGradCAM, LayerCAM.

Target: SemanticSegmentationTarget, the sum of one class's logits under the
predicted mask.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from octseg_torch.ops.resize import resize_bilinear

CAM_METHODS = [
    'GradCAM',
    'HiResCAM',
    'GradCAMElementWise',
    'GradCAMPlusPlus',
    'XGradCAM',
    'AblationCAM',
    'EigenCAM',
    'EigenGradCAM',
    'LayerCAM',
]


def _jet_rgb() -> np.ndarray:
    """cv2.applyColorMap(i, COLORMAP_JET) then BGR -> RGB, for i in 0..255:
    three clipped ramps of slope 4, and one entry where cv2's float table
    rounds down (blue at 159 is 1, not 2)."""
    i = np.arange(256)
    ramps = [np.minimum(4 * i - 382, 1148 - 4 * i),    # red
             np.minimum(4 * i - 128, 892 - 4 * i),     # green
             np.minimum(4 * i + 128, 638 - 4 * i)]     # blue
    table = np.clip(np.stack(ramps, axis=1), 0, 255).astype(np.uint8)
    table[159, 2] = 1
    return table


JET_RGB = _jet_rgb()


class SemanticSegmentationTarget:
    """target(logits) = sum of the class channel's logits where mask == 1."""

    def __init__(self, category: int, mask: np.ndarray):
        self.category = category
        self.mask = torch.as_tensor(np.asarray(mask, np.float32))

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        """Per sample of NCHW logits: (N,)."""
        mask = self.mask.to(logits.device)
        return (logits[:, self.category] * mask).sum(dim=(1, 2))


def _pca_first_component(a: np.ndarray) -> np.ndarray:
    """Projection onto the first principal component over channels (EigenCAM).
    a: (H, W, C) -> (H, W), sign-fixed to non-negative max response."""
    h, w, c = a.shape
    flat = a.reshape(-1, c)
    flat = flat - flat.mean(axis=0, keepdims=True)
    # SVD of (HW, C): first right singular vector = principal channel mix
    _u, _s, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[0]
    if proj.max() < -proj.min():
        proj = -proj
    return proj.reshape(h, w)


class CAMProcessor:
    """CAM extraction for a SegmentationModel in eval mode."""

    def __init__(self, model: torch.nn.Module, method: str = 'GradCAM',
                 feature_level: Optional[int] = None, percentile: int = 99):
        if method not in CAM_METHODS:
            raise ValueError(f'Unknown CAM method {method!r}; known: {CAM_METHODS}')
        self.model = model.eval()
        self.method = method
        if feature_level is None:
            # the deepest level the decoder reads: a level it ignores has
            # zero gradients (blank maps). Only PSPNet ignores the deep
            # pyramid (encoder depth 3); every other decoder reads features[5]
            feature_level = 3 if type(model.decoder).__name__ == 'PSPDecoder' else 5
        self.level = feature_level
        self.percentile = percentile
        self._device = next(model.parameters()).device

    # ---- core quantities -------------------------------------------------
    def _acts_and_grads(self, img: np.ndarray, target: SemanticSegmentationTarget):
        x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None]))
        with torch.no_grad():
            feats = self.model.encode(x.to(self._device))
        a = feats[self.level].detach().requires_grad_(True)
        tapped = list(feats)
        tapped[self.level] = a
        with torch.enable_grad():
            (g,) = torch.autograd.grad(target(self.model.decode(tapped)).sum(), a)
        hwc = (lambda t: t[0].permute(1, 2, 0).float().cpu().numpy())
        return hwc(a.detach()), hwc(g), feats

    def _ablation_weights(self, feats: List[torch.Tensor],
                          target: SemanticSegmentationTarget, chunk: int = 32) -> np.ndarray:
        """AblationCAM: per-channel target drop when the channel is zeroed,
        decoded ``chunk`` channels at a time."""
        a = feats[self.level]
        c = a.shape[1]
        with torch.no_grad():
            base = float(target(self.model.decode(feats))[0])
            scores = []
            for start in range(0, c, chunk):
                n = min(chunk, c - start)
                keep = torch.ones((n, c, 1, 1), dtype=a.dtype, device=a.device)
                keep[torch.arange(n), torch.arange(start, start + n)] = 0
                batch = [f.expand(n, *f.shape[1:]) for f in feats]
                batch[self.level] = a * keep
                scores.append(target(self.model.decode(batch)))
            scores = torch.cat(scores).float().cpu().numpy()
        # fraction of the target score lost per ablated channel: the divisor
        # keeps base's sign (dividing by abs(base) inverts every weight when
        # the masked-logit sum is negative)
        denom = base if abs(base) > 1e-8 else 1e-8
        return (base - scores) / denom

    # ---- public API --------------------------------------------------------
    def extract_activation_map(self, img: np.ndarray, category: int,
                               mask: np.ndarray) -> np.ndarray:
        """CAM heatmap in [0, 1] at image resolution.

        img: (H, W, 3) float32 preprocessed exactly as for prediction.
        mask: (H, W) predicted binary mask for the category.
        """
        target = SemanticSegmentationTarget(category, mask)
        a, g, feats = self._acts_and_grads(img.astype(np.float32), target)

        m = self.method
        if m == 'GradCAM':
            w = g.mean(axis=(0, 1))
            cam = np.maximum((a * w).sum(-1), 0)
        elif m == 'HiResCAM':
            cam = np.maximum((a * g).sum(-1), 0)
        elif m == 'GradCAMElementWise':
            cam = np.maximum(np.maximum(a * g, 0).sum(-1), 0)
        elif m == 'GradCAMPlusPlus':
            g2, g3 = g**2, g**3
            denom = 2 * g2 + (a * g3).sum(axis=(0, 1), keepdims=True)
            alpha = np.where(g != 0, g2 / np.where(denom != 0, denom, 1e-8), 0)
            w = (alpha * np.maximum(g, 0)).sum(axis=(0, 1))
            cam = np.maximum((a * w).sum(-1), 0)
        elif m == 'XGradCAM':
            w = (g * a).sum(axis=(0, 1)) / (a.sum(axis=(0, 1)) + 1e-8)
            cam = np.maximum((a * w).sum(-1), 0)
        elif m == 'AblationCAM':
            w = self._ablation_weights(feats, target)
            cam = np.maximum((a * w).sum(-1), 0)
        elif m == 'EigenCAM':
            cam = np.maximum(_pca_first_component(a), 0)
        elif m == 'EigenGradCAM':
            cam = np.maximum(_pca_first_component(a * g), 0)
        elif m == 'LayerCAM':
            cam = np.maximum((np.maximum(g, 0) * a).sum(-1), 0)
        else:  # pragma: no cover
            raise AssertionError(m)

        # robust normalize (pytorch_grad_cam scales by max; a percentile cap
        # is steadier), then resize to image resolution in float32
        cap = np.percentile(cam, self.percentile)
        cam = cam / (cap + 1e-7)
        cam = np.clip(cam, 0, 1)
        h, w_ = img.shape[:2]
        cam = torch.from_numpy(np.asarray(cam[:, :, None], np.float32))
        return np.clip(resize_bilinear(cam, (h, w_)).numpy()[:, :, 0], 0, 1)

    @staticmethod
    def overlay_activation_map(img: np.ndarray, cam: np.ndarray,
                               image_weight: float = 0.5) -> np.ndarray:
        """show_cam_on_image parity: the jet heatmap blended over the (uint8
        RGB) image."""
        heat = JET_RGB[(cam * 255).astype(np.uint8)].astype(np.float32) / 255
        base = img.astype(np.float32) / 255 if img.max() > 1 else img.astype(np.float32)
        out = (1 - image_weight) * heat + image_weight * base
        return (out / max(out.max(), 1e-7) * 255).astype(np.uint8)
