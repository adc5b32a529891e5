"""The flat retrieval-split container (copy of ``EEGRetrievalData`` from
``eeg_image_decode_tpu/data/things_eeg.py``). Its arrays are numpy arrays,
or tensors already on a device (``data/synthetic.py::
make_synthetic_retrieval_data``). The THINGS-EEG file readers are not
ported yet (ROADMAP.md)."""

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

    @property
    def n(self) -> int:
        return int(self.eeg.shape[0])

    def class_img_features(self):
        """One image feature per class (the train-time probe's targets)."""
        return self.img_features[:: self.images_per_class]
