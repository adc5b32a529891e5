"""CLIP feature caches (counterpart of ``eeg_image_decode_tpu/data/features.py``).

Caches are framework-neutral ``.npz`` files keyed by (model, split, content
fingerprint of the image list), so switching image directories can never
silently reuse old features. The readers, the writer and the key derivation
are ported; the CLIP encoders that fill a cache are not yet (ROADMAP.md).
The serving gallery is such a file (``img_features_test`` or
``img_features``, (N, 1024)).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _fingerprint(items: list[str]) -> str:
    h = hashlib.sha256()
    for it in items:
        h.update(it.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def cache_path(cache_dir: str, model_name: str, split: str,
               image_paths: list[str]) -> str:
    fp = _fingerprint(image_paths)
    safe = model_name.replace("/", "-")
    return os.path.join(cache_dir, f"{safe}_features_{split}_{fp}.npz")


def clip_cache_path(cache_dir: str, split: str, image_paths: list[str], *,
                    model_name: str = "ViT-H-14",
                    normalize_img: bool = True) -> str:
    """The cache file of one (model, normalisation, split, image list): the
    single source of the key derivation."""
    tag = f"{model_name}-{'n' if normalize_img else 'r'}"
    return cache_path(cache_dir, tag, split, image_paths)


def save_features(path: str, *, img_features: np.ndarray,
                  text_features: np.ndarray, **extra) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, img_features=np.asarray(img_features, np.float32),
             text_features=np.asarray(text_features, np.float32), **extra)


def load_features(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
