"""Retrieval serving (counterpart of ``RetrievalService`` in
``eeg_image_decode_tpu/serve.py``): EEG epochs in → top-k gallery indices
out.

The gallery (CLIP features of the candidate images) lives on the device.
One request is encoded by the ATM-S forward (three CUDA kernels on the
card), scored as ``scale · f32(feats) @ galleryᵀ`` and ranked to the top
``k_cap`` on the device; the host slices to the client's k. Requests are
chunked by ``max_batch`` and each chunk is padded to the smallest bucket of
``(8, 32, max_batch)`` that fits, as in the JAX service. The reconstruction
and caption services are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from eeg_image_decode_tpu_torch.utils.device import resolve_device


def _check_request(eeg: np.ndarray, subject_ids) -> tuple[np.ndarray, np.ndarray]:
    """Shared request validation: a zero-row request would otherwise crash in
    ``np.concatenate`` after the (empty) chunk loop — fail fast with a clear
    message instead (the HTTP daemon maps ValueError → 400)."""
    eeg = np.asarray(eeg, np.float32)
    if eeg.ndim != 3:
        raise ValueError(f"eeg must be (B, C, T); got shape {eeg.shape}")
    if eeg.shape[0] == 0:
        raise ValueError("request contains zero EEG rows")
    subject_ids = np.asarray(subject_ids, np.int32)
    if subject_ids.ndim == 0:  # scalar OR 0-d array (JSON/npz wire forms)
        subject_ids = np.full(eeg.shape[0], subject_ids, np.int32)
    if subject_ids.shape != (eeg.shape[0],):
        raise ValueError(
            f"subject_ids shape {subject_ids.shape} does not match "
            f"batch size {eeg.shape[0]}"
        )
    return eeg, subject_ids


class RetrievalService:
    """``model``: an eval-mode ``ContrastiveModel`` (``build_encoder``);
    it is moved to ``device`` (default: the CUDA card, raising without one;
    ``device="cpu"`` runs the plain versions on the CPU)."""

    def __init__(self, model: torch.nn.Module, gallery_features: np.ndarray,
                 *, max_batch: int = 256, transfer_dtype=None,
                 k_cap: int = 64, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.gallery = torch.as_tensor(
            np.asarray(gallery_features, np.float32), device=self.device)
        self.max_batch = max_batch
        # one program serves every k ≤ k_cap: the device ranks the top
        # k_cap and the host slices to k; a rare k > k_cap ranks the whole
        # gallery
        self.k_cap = max(1, min(k_cap, int(gallery_features.shape[0])))
        # host→device wire format for the EEG rows (float16 halves the
        # copy; the bf16 serving model rounds its input further anyway)
        self.transfer_dtype = np.dtype(transfer_dtype) if transfer_dtype \
            else None
        # a chunk pads to the SMALLEST bucket that fits, so a single small
        # request keeps its small-dispatch latency while a coalesced burst
        # (server.py::_Coalescer) rides one big dispatch
        self.buckets = tuple(sorted({
            b for b in (8, 32, max_batch) if b <= max_batch
        }))

    @torch.inference_mode()
    def _query(self, eeg: np.ndarray, sids: np.ndarray, k: int):
        x = torch.from_numpy(eeg).to(self.device)
        s = torch.from_numpy(sids).to(self.device)
        feats, scale = self.model(x, s)
        logits = scale * (feats.float() @ self.gallery.T)
        return torch.topk(logits, k, dim=-1)

    def warmup(self, eeg_shape: tuple[int, int]) -> None:
        """One dummy dispatch per bucket over ``eeg_shape=(C, T)`` before
        accepting traffic, so the kernel build and the library handles are
        paid before the first request."""
        c, t = eeg_shape
        for b in self.buckets:
            self.top_k(np.zeros((b, c, t), np.float32), np.zeros(b, np.int32),
                       k=1)

    def top_k(self, eeg: np.ndarray, subject_ids: np.ndarray | int,
              k: int = 5) -> tuple[np.ndarray, np.ndarray]:
        """(B, C, T) EEG → (scores (B, k) float32, gallery indices (B, k))."""
        eeg, subject_ids = _check_request(eeg, subject_ids)
        n_gallery = int(self.gallery.shape[0])
        if not 1 <= k <= n_gallery:
            raise ValueError(
                f"k must be in [1, {n_gallery}] (gallery size); got {k}"
            )
        kq = self.k_cap if k <= self.k_cap else n_gallery
        chunks = []
        for start in range(0, eeg.shape[0], self.max_batch):
            chunk = eeg[start : start + self.max_batch]
            sids = subject_ids[start : start + self.max_batch]
            m = chunk.shape[0]
            bucket = next(b for b in self.buckets if b >= m)
            pad = bucket - m
            eeg_p = np.pad(chunk, ((0, pad), (0, 0), (0, 0)))
            if self.transfer_dtype is not None:
                eeg_p = eeg_p.astype(self.transfer_dtype)
            sid_p = np.pad(sids, (0, pad))
            scores, idx = self._query(eeg_p, sid_p, kq)
            # device results stay queued; one readback after the loop
            chunks.append((scores[:m, :k], idx[:m, :k]))
        return (
            torch.cat([s for s, _ in chunks]).cpu().numpy(),
            torch.cat([i for _, i in chunks]).cpu().numpy().astype(np.int32),
        )
