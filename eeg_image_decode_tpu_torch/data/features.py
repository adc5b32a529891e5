"""CLIP feature caches (counterpart of ``eeg_image_decode_tpu/data/features.py``).

Only the reader is ported: the serving gallery is a cached ``.npz`` of CLIP
image features (``img_features_test`` or ``img_features``, (N, 1024)).
"""

from __future__ import annotations

import numpy as np


def load_features(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
