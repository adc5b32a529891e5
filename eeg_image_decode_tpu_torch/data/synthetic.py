"""Synthetic THINGS-EEG-shaped data (copy of ``eeg_image_decode_tpu/data/synthetic.py``).

Real THINGS-EEG + CLIP caches aren't shipped with either repo, so every
integration test and the throughput benchmark run on synthetic data with the
exact real shapes (train (n_cls*10*4, 63, 250), test (200, 63, 250), CLIP dim
1024). The EEG carries a low-rank class signature projected through a random
mixing matrix plus noise, and the "CLIP" features are unit-norm class anchors
with per-image jitter — so contrastive training genuinely learns and k-way
retrieval rises above chance, validating the full pipeline end-to-end.
"""

from __future__ import annotations

import numpy as np

from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData


def make_synthetic_retrieval_data(
    n_classes: int = 40,
    images_per_class: int = 10,
    train_reps: int = 4,
    n_channels: int = 63,
    n_timepoints: int = 250,
    clip_dim: int = 1024,
    n_test_classes: int | None = None,
    snr: float = 1.0,
    seed: int = 20200220,
    subject_id: int = 1,
) -> tuple[EEGRetrievalData, EEGRetrievalData]:
    """Returns (train, test) splits sharing class structure.

    Test classes are the first ``n_test_classes`` (default: all) with fresh
    EEG noise, mirroring the real setup where test EEG is averaged over many
    repetitions (lower noise → we draw one clean-ish epoch).
    """
    rng = np.random.default_rng(seed)
    if n_test_classes is None:
        n_test_classes = n_classes

    # class anchors in CLIP space (unit norm)
    anchors = rng.normal(size=(n_classes, clip_dim)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)

    # per-image features: anchor + jitter, renormalized (train targets)
    img_feats = anchors[:, None, :] + 0.1 * rng.normal(
        size=(n_classes, images_per_class, clip_dim)
    ).astype(np.float32)
    img_feats /= np.linalg.norm(img_feats, axis=-1, keepdims=True)
    img_feats = img_feats.reshape(n_classes * images_per_class, clip_dim)

    text_feats = anchors + 0.05 * rng.normal(size=anchors.shape).astype(np.float32)
    text_feats /= np.linalg.norm(text_feats, axis=-1, keepdims=True)

    # latent class signatures mixed into channel×time EEG
    rank = 16
    class_latent = rng.normal(size=(n_classes, rank)).astype(np.float32)
    mix = rng.normal(size=(rank, n_channels, n_timepoints)).astype(np.float32)
    mix /= np.sqrt(rank)

    def _epochs(labels: np.ndarray, noise_scale: float) -> np.ndarray:
        signal = np.einsum("nr,rct->nct", class_latent[labels], mix)
        noise = rng.normal(size=signal.shape).astype(np.float32)
        return (snr * signal + noise_scale * noise).astype(np.float32)

    n_train = n_classes * images_per_class * train_reps
    train_labels = np.repeat(
        np.arange(n_classes, dtype=np.int32), images_per_class * train_reps
    )
    train_eeg = _epochs(train_labels, noise_scale=1.0)
    local = np.arange(n_train)
    train = EEGRetrievalData(
        eeg=train_eeg,
        labels=train_labels,
        subject_ids=np.full(n_train, subject_id, np.int32),
        img_idx=(local // train_reps).astype(np.int32),
        text_idx=(local // (images_per_class * train_reps)).astype(np.int32),
        img_features=img_feats,
        text_features=text_feats,
        n_classes=n_classes,
        images_per_class=images_per_class,
    )

    test_labels = np.arange(n_test_classes, dtype=np.int32)
    # test features: the held-out image of each class ≈ anchor + fresh jitter
    test_img = anchors[:n_test_classes] + 0.1 * rng.normal(
        size=(n_test_classes, anchors.shape[1])
    ).astype(np.float32)
    test_img /= np.linalg.norm(test_img, axis=-1, keepdims=True)
    test = EEGRetrievalData(
        eeg=_epochs(test_labels, noise_scale=0.25),  # rep-averaged → less noise
        labels=test_labels,
        subject_ids=np.full(n_test_classes, subject_id, np.int32),
        img_idx=np.arange(n_test_classes, dtype=np.int32),
        text_idx=np.arange(n_test_classes, dtype=np.int32),
        img_features=test_img,
        text_features=text_feats[:n_test_classes],
        n_classes=n_test_classes,
        images_per_class=1,
    )
    return train, test
