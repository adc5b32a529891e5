"""Synthetic THINGS-EEG-shaped data (counterpart of ``eeg_image_decode_tpu/data/synthetic.py``).

Real THINGS-EEG + CLIP caches aren't shipped with either repo, so every
integration test and the throughput benchmark run on synthetic data with the
exact real shapes (train (n_cls*10*4, 63, 250), test (200, 63, 250), CLIP dim
1024). The EEG carries a low-rank class signature projected through a random
mixing matrix plus noise, and the "CLIP" features are unit-norm class anchors
with per-image jitter — so contrastive training genuinely learns and k-way
retrieval rises above chance, validating the full pipeline end-to-end.
"""

from __future__ import annotations

import math

import torch

from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
from eeg_image_decode_tpu_torch.utils.device import resolve_device


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
    device: str | torch.device | None = None,
) -> tuple[EEGRetrievalData, EEGRetrievalData]:
    """Returns (train, test) splits sharing class structure, as tensors on
    ``device`` (default: the CUDA card, raising without one; pass
    ``device="cpu"`` for the CPU).

    Test classes are the first ``n_test_classes`` (default: all) with fresh
    EEG noise, mirroring the real setup where test EEG is averaged over many
    repetitions (lower noise → we draw one clean-ish epoch).

    The JAX package's recipe (class anchors, a rank-16 class signature mixed
    into channel × time, unit-variance noise), drawn with a
    ``torch.Generator`` on ``device``, so a split of one subject's real size
    (1654 classes: 66,160 × 63 × 250 fp32, 4.2 GB) never passes through the
    host. The draws differ from the numpy recipe's; the shapes, scales and
    class structure are the same.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    if n_test_classes is None:
        n_test_classes = n_classes

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def unit(a):
        return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)

    # class anchors in CLIP space (unit norm); per-image features: anchor +
    # jitter, renormalized (train targets)
    anchors = unit(randn(n_classes, clip_dim))
    img_feats = unit(anchors[:, None, :]
                     + 0.1 * randn(n_classes, images_per_class, clip_dim))
    img_feats = img_feats.reshape(n_classes * images_per_class, clip_dim)
    text_feats = unit(anchors + 0.05 * randn(n_classes, clip_dim))
    # latent class signatures mixed into channel×time EEG
    rank = 16
    class_latent = randn(n_classes, rank)
    mix = randn(rank, n_channels * n_timepoints) / math.sqrt(rank)

    def epochs(labels: torch.Tensor, noise_scale: float) -> torch.Tensor:
        out = torch.empty((len(labels), n_channels * n_timepoints),
                          device=dev)
        for lo in range(0, len(labels), 8192):  # bounded temporaries
            hi = min(lo + 8192, len(labels))
            out[lo:hi] = snr * (class_latent[labels[lo:hi]] @ mix) \
                + noise_scale * randn(hi - lo, n_channels * n_timepoints)
        return out.reshape(len(labels), n_channels, n_timepoints)

    i32 = dict(dtype=torch.int32, device=dev)
    n_train = n_classes * images_per_class * train_reps
    train_labels = torch.arange(n_classes, **i32).repeat_interleave(
        images_per_class * train_reps)
    local = torch.arange(n_train, **i32)
    train = EEGRetrievalData(
        eeg=epochs(train_labels.long(), 1.0),
        labels=train_labels,
        subject_ids=torch.full((n_train,), subject_id, **i32),
        img_idx=local // train_reps,
        text_idx=local // (images_per_class * train_reps),
        img_features=img_feats,
        text_features=text_feats,
        n_classes=n_classes,
        images_per_class=images_per_class,
    )
    test_labels = torch.arange(n_test_classes, **i32)
    # test features: the held-out image of each class ≈ anchor + fresh jitter
    test_img = unit(anchors[:n_test_classes]
                    + 0.1 * randn(n_test_classes, clip_dim))
    test = EEGRetrievalData(
        eeg=epochs(test_labels.long(), 0.25),  # rep-averaged → less noise
        labels=test_labels,
        subject_ids=torch.full((n_test_classes,), subject_id, **i32),
        img_idx=torch.arange(n_test_classes, **i32),
        text_idx=torch.arange(n_test_classes, **i32),
        img_features=test_img,
        text_features=text_feats[:n_test_classes],
        n_classes=n_test_classes,
        images_per_class=1,
    )
    return train, test
