"""Reconstruction quality metrics (counterpart of
``eeg_image_decode_tpu/eval/recon_metrics.py``).

The MindEye-derived table of ``Generation/Reconstruction_Metrics_ATM.ipynb``
(cells 8-24):

- PixCorr: per-pair Pearson correlation of flattened pixels (cell 10);
- SSIM: grayscale structural similarity with skimage's gaussian window
  (cell 12);
- two-way identification (cells 14-18): the share of ordered pairs
  (i, j ≠ i) with corr(gen_i, gt_i) > corr(gen_i, gt_j), over the features
  of any extractor (AlexNet-2/5, InceptionV3, CLIP);
- feature distance (cells 20-22): the mean per-pair correlation distance
  (the EffNet-B and SwAV rows).

Images are (N, H, W, 3) tensors in [0, 1], as in the JAX package, on any
device; the functions return 0-d tensors and :func:`reconstruction_metrics`
a dict of Python floats. The JAX module is plain XLA, so this is plain
PyTorch: no TPU kernel lies on this path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) → (N, size, size, C), as ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, and a triangle filter widened by the
    scale (antialiased) where it downscales."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def _rowwise_corr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation per row of two (N, D) tensors."""
    a = a - a.mean(dim=1, keepdim=True)
    b = b - b.mean(dim=1, keepdim=True)
    num = torch.sum(a * b, dim=1)
    den = torch.sqrt(torch.sum(a * a, dim=1) * torch.sum(b * b, dim=1)) + 1e-12
    return num / den


def pixcorr(generated: torch.Tensor, ground_truth: torch.Tensor
            ) -> torch.Tensor:
    """Mean per-image pixel correlation (ref cell 10)."""
    return torch.mean(_rowwise_corr(_flat(generated), _flat(ground_truth)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) → (N, H, W) luma (ITU-R 601, as PIL's ``'L'``)."""
    if images.ndim == 4 and images.shape[-1] == 3:
        w = images.new_tensor([0.299, 0.587, 0.114], dtype=torch.float32)
        return images.float() @ w
    return images.float()


def ssim(generated: torch.Tensor, ground_truth: torch.Tensor, *,
         data_range: float = 1.0, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean grayscale SSIM (ref cell 12: skimage's ``gaussian_weights=True,
    sigma=1.5, use_sample_covariance=False``), over the VALID positions of
    the window."""
    x = to_grayscale(generated)[:, None]
    y = to_grayscale(ground_truth)[:, None]
    w = torch.from_numpy(_gaussian_window(window_size, sigma)).to(x.device)
    w = w[None, None]

    def filt(img):
        return F.conv2d(img, w)

    mu_x, mu_y = filt(x), filt(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = filt(x * x) - mu_xx
    sig_y = filt(y * y) - mu_yy
    sig_xy = filt(x * y) - mu_xy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sig_x + sig_y + c2))
    return torch.mean(s)


def two_way_identification(gen_features: torch.Tensor,
                           gt_features: torch.Tensor) -> torch.Tensor:
    """Share of ordered pairs (i, j ≠ i) with corr(gen_i, gt_i) >
    corr(gen_i, gt_j), strictly: a tie counts as a loss (ref cell 8's
    ``two_way_identification``)."""
    g = _flat(gen_features)
    t = _flat(gt_features)
    g = g - g.mean(dim=1, keepdim=True)
    t = t - t.mean(dim=1, keepdim=True)
    g = g / (torch.linalg.norm(g, dim=1, keepdim=True) + 1e-12)
    t = t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-12)
    corr = g @ t.T
    wins = (corr.diagonal()[:, None] > corr).float()
    n = corr.shape[0]
    return wins.sum() / (n * (n - 1))  # the diagonal never beats itself


def feature_distance(gen_features: torch.Tensor,
                     gt_features: torch.Tensor) -> torch.Tensor:
    """Mean per-pair correlation distance, 1 − corr (ref cells 20-22)."""
    return torch.mean(
        1.0 - _rowwise_corr(_flat(gen_features), _flat(gt_features)))


def make_clip_extractor(tower, *, image_size: int | None = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → unit-norm features through a CLIP vision tower
    (``models/clip_vit.py::CLIPVisionTower``; the notebook's ViT-L/14 row,
    cell 18): the resize of :func:`resize_bilinear`, CLIP's normalisation,
    the tower, an L2 norm."""
    from eeg_image_decode_tpu_torch.models.clip_vit import clip_preprocess

    size = image_size or tower.config.image_size

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        if images.shape[1] != size:
            images = resize_bilinear(images, size)
        feats = tower(clip_preprocess(images))
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)

    return extract


@torch.no_grad()
def reconstruction_metrics(
    generated: torch.Tensor,
    ground_truth: torch.Tensor,
    feature_extractors: dict[str, Callable[[torch.Tensor], torch.Tensor]]
    | None = None,
) -> dict[str, float]:
    """The full table over aligned (N, H, W, 3) batches in [0, 1].

    Each entry of ``feature_extractors`` (name → images → features) adds a
    ``2way_<name>`` and a ``dist_<name>`` row, in the order given."""
    out = {
        "pixcorr": float(pixcorr(generated, ground_truth)),
        "ssim": float(ssim(generated, ground_truth)),
    }
    for name, fn in (feature_extractors or {}).items():
        gf, tf = fn(generated), fn(ground_truth)
        out[f"2way_{name}"] = float(two_way_identification(gf, tf))
        out[f"dist_{name}"] = float(feature_distance(gf, tf))
    return out
