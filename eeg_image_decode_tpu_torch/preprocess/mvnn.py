"""Multivariate noise normalization (MVNN): whitening by the inverse matrix
square root of the average epoch covariance (counterpart of
``eeg_image_decode_tpu/preprocess/mvnn.py``; ref
``EEG-preprocessing/preprocessing_utils.py:116-196``).

- per-epoch covariance: the Ledoit-Wolf-shrunk channel covariance of each
  epoch (``mvnn_dim='epochs'``, ref ``:173-177``; what sklearn's
  ``_cov(..., shrinkage='auto')`` computes), averaged over epochs;
- session covariance: from the **training partition only** (ref ``:183``);
- whitener: Σ^{-1/2} through a symmetric eigendecomposition with clamped
  eigenvalues.

Every function takes torch tensors and runs on their device. The
covariances are float64 batched products on that device, one chunk of
epochs at a time; the whitener is applied in the epochs' dtype (float32),
as the JAX package does, with TF32 off.
"""

from __future__ import annotations

import torch

from eeg_image_decode_tpu_torch.utils.device import resolve_device

#: epochs per batched float64 product: 1024 epochs of 251 × 63 take 130 MB
LW_CHUNK = 1024


def ledoit_wolf_cov(x: torch.Tensor) -> torch.Tensor:
    """Ledoit-Wolf shrunk covariance of (n_samples, n_features) data, in
    float64: Σ_lw = (1−δ)·S + δ·μ·I with δ = min(β/Δ, 1), as sklearn's
    ``ledoit_wolf``."""
    return ledoit_wolf_cov_batched(x[None])[0]


def ledoit_wolf_cov_batched(x: torch.Tensor,
                            chunk: int = LW_CHUNK) -> torch.Tensor:
    """Batched :func:`ledoit_wolf_cov`: (N, n_samples, n_features) →
    (N, n_features, n_features) float64 on ``x``'s device, ``chunk`` epochs
    per batched product. The caller's tensor is not changed."""
    n_total, n, p = x.shape
    eye = torch.eye(p, dtype=torch.float64, device=x.device)
    out = torch.empty((n_total, p, p), dtype=torch.float64, device=x.device)
    for i in range(0, n_total, chunk):
        xi = x[i:i + chunk].to(torch.float64, copy=True)
        xi -= xi.mean(dim=1, keepdim=True)
        s = torch.matmul(xi.transpose(1, 2), xi)
        s /= n
        mu = torch.diagonal(s, dim1=1, dim2=2).sum(dim=1) / p
        delta = ((s - mu[:, None, None] * eye) ** 2).sum(dim=(1, 2)) / p
        # Σ_ij Σ_n x²[n,i]·x²[n,j] = Σ_n (Σ_i x²[n,i])²: O(n·p), not O(n·p²)
        xi.mul_(xi)
        row2 = xi.sum(dim=2)
        beta_raw = (row2 ** 2).sum(dim=1) / n - (s ** 2).sum(dim=(1, 2))
        beta = beta_raw / (n * p)
        shrinkage = torch.where(delta == 0, torch.zeros_like(beta),
                                beta / delta).clamp(0.0, 1.0)
        out[i:i + chunk] = ((1.0 - shrinkage)[:, None, None] * s
                            + (shrinkage * mu)[:, None, None] * eye)
    return out


def matrix_inverse_sqrt(sigma: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """Σ^{-1/2} of a symmetric PSD Σ, in float64, through ``eigh`` with the
    eigenvalues clamped at ``eps · max``."""
    sigma = sigma.to(torch.float64)
    sigma = 0.5 * (sigma + sigma.T)
    w, v = torch.linalg.eigh(sigma)
    w = torch.clamp(w, min=eps * float(w.max()))
    return (v * w ** -0.5) @ v.T


def session_covariance(epoched: torch.Tensor,
                       chunk: int = LW_CHUNK) -> torch.Tensor:
    """(conditions, reps, C, T) → (C, C) float64: the Ledoit-Wolf covariance
    of each epoch (channels over time samples), averaged over all epochs
    (equal rep counts: the mean over reps, then conditions)."""
    n_cond, n_rep, n_ch, t = epoched.shape
    x = epoched.reshape(n_cond * n_rep, n_ch, t).transpose(1, 2)  # (N, T, C)
    return ledoit_wolf_cov_batched(x, chunk).mean(dim=0)


def mvnn_whiten(epoched_train: list[torch.Tensor],
                epoched_test: list[torch.Tensor]
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Whiten each session's training and test epochs, (conditions, reps,
    C, T) each, with that session's training-partition Σ^{-1/2} (ref
    ``:148-193``): Σ^{-1/2} @ X on the channel axis, in the epochs' dtype."""
    out_train, out_test = [], []
    for tr, te in zip(epoched_train, epoched_test):
        resolve_device(tr.device)  # on the card: full fp32 products
        sigma_inv = matrix_inverse_sqrt(session_covariance(tr))

        def whiten(x: torch.Tensor) -> torch.Tensor:
            flat = x.reshape(-1, *x.shape[-2:])
            return torch.matmul(sigma_inv.to(x.dtype), flat).reshape(x.shape)

        out_train.append(whiten(tr))
        out_test.append(whiten(te))
    return out_train, out_test
