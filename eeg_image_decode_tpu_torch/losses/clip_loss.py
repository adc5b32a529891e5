"""CLIP-style symmetric InfoNCE (counterpart of
``eeg_image_decode_tpu/losses/clip_loss.py``, ref ``models/loss.py:78-141``).

Given feature matrices A, B (N, D) and a scalar ``logit_scale``, the loss is

    L = (CE(s·A@Bᵀ, arange(N)) + CE(s·B@Aᵀ, arange(N))) / 2

with the logits and the logsumexp in fp32. Features are used as they come
(no re-normalisation inside the loss), and the scale multiplies the logits
as it is: the reference passes the raw trainable parameter (init ln(1/0.07))
and never exponentiates it (``Retrieval/ATMS_retrieval.py:227-229``).

``clip_loss_distributed`` is the loss over a data-parallel mesh: each rank
holds its rows of the two towers and gathers the others' through
``parallel/collectives.py`` (the reference's ``gather_features``,
``models/loss.py:20-130``).
"""

from __future__ import annotations

import torch

from eeg_image_decode_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    gather_features,
)


def _cross_entropy_with_arange(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with labels = arange(N), in fp32."""
    logits = logits.float()
    return (torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)).mean()


def symmetric_infonce(feat_a: torch.Tensor, feat_b: torch.Tensor,
                      scale: torch.Tensor | float) -> torch.Tensor:
    """Both-direction InfoNCE (ref ``models/loss.py:122-140``, one device)."""
    logits_ab = scale * torch.matmul(feat_a.float(), feat_b.float().T)
    return 0.5 * (_cross_entropy_with_arange(logits_ab)
                  + _cross_entropy_with_arange(logits_ab.T))


def clip_loss(feat_a: torch.Tensor, feat_b: torch.Tensor,
              logit_scale: torch.Tensor | float) -> torch.Tensor:
    """ClipLoss.forward, one-device path; ``logit_scale`` is the multiplier
    as it is."""
    return symmetric_infonce(feat_a, feat_b, logit_scale)


def retrieval_loss(eeg_feat: torch.Tensor, img_feat: torch.Tensor,
                   text_feat: torch.Tensor, scale: torch.Tensor | float,
                   alpha: float = 0.99) -> torch.Tensor:
    """Retrieval objective: 0.99·img_clip + 0.01·text_clip
    (ref ``Retrieval/ATMS_retrieval.py:206,229-234``)."""
    img_loss = symmetric_infonce(eeg_feat, img_feat, scale)
    text_loss = symmetric_infonce(eeg_feat, text_feat, scale)
    return alpha * img_loss + (1.0 - alpha) * text_loss


def reconstruction_loss(eeg_feat: torch.Tensor, img_feat: torch.Tensor,
                        scale: torch.Tensor | float,
                        alpha: float = 0.90) -> torch.Tensor:
    """Reconstruction objective: α·MSE·10 + (1−α)·img_clip·10 against
    unnormalised CLIP targets
    (ref ``Generation/ATMS_reconstruction.py:198,227-228``)."""
    mse = torch.mean((eeg_feat.float() - img_feat.float()) ** 2)
    img_clip = symmetric_infonce(eeg_feat, img_feat, scale)
    return alpha * mse * 10.0 + (1.0 - alpha) * img_clip * 10.0


def clip_loss_distributed(feat_a: torch.Tensor, feat_b: torch.Tensor,
                          logit_scale: torch.Tensor | float, *, mesh,
                          local_loss: bool = False) -> torch.Tensor:
    """InfoNCE over the global batch of ``mesh``'s dp group; ``feat_a`` and
    ``feat_b`` are this rank's (N_local, D) rows, the rank's block of the
    global batch in rank order. Returns the same scalar on every rank.

    - global (default): every rank gathers both towers and computes the
      full (N_global, N_global) loss;
    - ``local_loss=True``: each rank computes its (N_local, N_global) block
      against the gathered other tower, labels ``arange(N_local) +
      dp_rank·N_local``, and the per-rank sums are all-reduced over N_global
      (ref ``models/loss.py:113-130``).

    Each rank back-propagates its copy, so the gradient reaching its rows
    is dp times its share; the dp mean of the parameter gradients
    (``parallel/collectives.py::pmean_tree``) divides that out."""
    all_a, all_b = gather_features(feat_a, feat_b, mesh)
    if not local_loss:
        return symmetric_infonce(all_a, all_b, logit_scale)
    n_local, n_global = feat_a.shape[0], all_a.shape[0]
    labels = torch.arange(n_local, device=feat_a.device) + (
        mesh.dp_rank * n_local)

    def ce_sum(logits):
        logits = logits.float()
        picked = logits.gather(1, labels[:, None])[:, 0]
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    logits_ab = logit_scale * torch.matmul(feat_a.float(), all_b.float().T)
    logits_ba = logit_scale * torch.matmul(feat_b.float(), all_a.float().T)
    loss = 0.5 * (ce_sum(logits_ab) + ce_sum(logits_ba)) / n_global
    return all_reduce_sum(loss, mesh.dp_group)
