"""THINGS-EEG-shaped data made on the device from the seed: a training
split of n_classes × images_per_class × reps epochs (C × T), the test split
of one epoch per test class, 1024-d unit-norm CLIP image and text targets.
The EEG carries a rank-16 class signature mixed into channel × time plus
unit noise (rep-averaged test epochs: a quarter of it), so training learns.
"""

from __future__ import annotations

import math

import torch

from benchmarks.harness.weights import derive_seed

#: rows drawn per call for the EEG
ROWS_PER_DRAW = 8192


def make_split(d: dict, seed: int, device) -> dict:
    """``d``: the configuration's ``data``. Returns tensors on ``device``:
    ``eeg`` (N, C, T) fp32, ``labels``, ``subject_ids``, ``img_idx``,
    ``text_idx`` (int32), ``img_features``, ``text_features``, and the same
    under ``test_``. ``subjects`` equal blocks of rows take the ids
    0 … subjects − 1."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(derive_seed(seed, "data"))
    n_cls, ipc, reps = d["n_classes"], d["images_per_class"], d["reps"]
    c, t, dim = d["n_channels"], d["n_timepoints"], d["clip_dim"]
    n_test, subjects = d["n_test_classes"], d.get("subjects", 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def unit(a):
        return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)

    anchors = unit(randn(n_cls, dim))
    img = unit(anchors[:, None, :] + 0.1 * randn(n_cls, ipc, dim)
               ).reshape(n_cls * ipc, dim)
    text = unit(anchors + 0.05 * randn(n_cls, dim))
    latent = randn(n_cls, 16)
    mix = randn(16, c * t) / math.sqrt(16)

    def epochs(labels, noise):
        out = torch.empty((len(labels), c * t), device=dev)
        for lo in range(0, len(labels), ROWS_PER_DRAW):
            hi = min(lo + ROWS_PER_DRAW, len(labels))
            out[lo:hi] = latent[labels[lo:hi]] @ mix + noise * randn(
                hi - lo, c * t)
        return out.reshape(len(labels), c, t)

    i32 = dict(dtype=torch.int32, device=dev)
    n_per = n_cls * ipc * reps
    labels = torch.arange(n_cls, **i32).repeat_interleave(ipc * reps)
    local = torch.arange(n_per, **i32)
    out = {
        "eeg": torch.cat([epochs(labels.long(), 1.0)
                          for _ in range(subjects)]),
        "labels": labels.repeat(subjects),
        "subject_ids": torch.arange(subjects, **i32).repeat_interleave(n_per),
        "img_idx": (local // reps).repeat(subjects),
        "text_idx": (local // (ipc * reps)).repeat(subjects),
        "img_features": img, "text_features": text,
    }
    tl = torch.arange(n_test, **i32)
    out.update({
        "test_eeg": epochs(tl.long(), 0.25), "test_labels": tl,
        "test_subject_ids": torch.zeros(n_test, **i32),
        "test_img_idx": tl, "test_text_idx": tl,
        "test_img_features": unit(anchors[:n_test]
                                  + 0.1 * randn(n_test, dim)),
        "test_text_features": text[:n_test],
    })
    return out


def eeg_pool(n: int, c: int, t: int, seed: int, device) -> torch.Tensor:
    """``n`` unit-variance EEG epochs (n, C, T) fp32 for requests."""
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "pool"))
    return torch.randn((n, c, t), generator=g, device=device)
