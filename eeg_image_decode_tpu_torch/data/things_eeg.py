"""The flat retrieval-split container (copy of ``EEGRetrievalData`` from
``eeg_image_decode_tpu/data/things_eeg.py``). The THINGS-EEG file readers
are not ported yet (ROADMAP.md)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EEGRetrievalData:
    """Flat view of one retrieval dataset split (possibly multi-subject)."""

    eeg: np.ndarray  # (N, C, T) float32
    labels: np.ndarray  # (N,) int32 class ids
    subject_ids: np.ndarray  # (N,) int32
    img_idx: np.ndarray  # (N,) int32 index into img_features
    text_idx: np.ndarray  # (N,) int32 index into text_features
    img_features: np.ndarray  # (n_imgs, D) float32
    text_features: np.ndarray  # (n_cls, D) float32
    n_classes: int
    images_per_class: int = 1
