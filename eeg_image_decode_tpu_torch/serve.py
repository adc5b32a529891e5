"""Retrieval serving (counterpart of ``RetrievalService`` in
``eeg_image_decode_tpu/serve.py``): EEG epochs in → top-k gallery indices
out.

The gallery (CLIP features of the candidate images) lives on the device.
One request is encoded by the ATM-S forward (three CUDA kernels on the
card), scored as ``scale · f32(feats) @ galleryᵀ`` and ranked to the top
``k_cap`` on the device; the host slices to the client's k. Requests are
chunked by ``max_batch`` and each chunk is padded to the smallest bucket of
``(8, 32, max_batch)`` that fits, as in the JAX service.

:class:`ReconstructionService` is EEG → images: the ATM-S eval forward (the
attention and tsconv kernels on the card) → the diffusion prior's CFG
sampling → SDXL-turbo + IP-Adapter (``gen/sdxl.py``) → the VAE decode.
Every draw is per row, keyed by the row's (seed, row) pair, so a row's
image does not depend on the batch it rides in.

:class:`CaptionService` is EEG → captions: the same encoder forward and
prior sampling (the same ``PRIOR_DOMAIN`` row keys, so a (seed, row) samples
the same CLIP embedding in both services) → ``PixelProjector`` → GIT's
greedy decode (``models/git_caption.py``) → WordPiece.
"""

from __future__ import annotations

import numpy as np
import torch

from eeg_image_decode_tpu_torch.utils import profiling
from eeg_image_decode_tpu_torch.utils.device import resolve_device

#: row-key domains: the prior's draws and SDXL's of one (seed, row)
PRIOR_DOMAIN, SDXL_DOMAIN = 0, 1


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


def _default_row_seeds(n: int, seed: int) -> np.ndarray:
    """(seed, row-index-within-request) pairs, the per-row identity of the
    draws: noise derived from these (not from a batch-level key) makes a
    row's output independent of the batch it rides in, so the HTTP
    coalescer (``server.py::_Coalescer``) can merge concurrent seeded
    requests without changing anyone's result."""
    return np.stack([np.full(n, seed, np.uint32),
                     np.arange(n, dtype=np.uint32)], axis=1)


def _check_row_seeds(row_seeds, n: int, seed: int) -> np.ndarray:
    """Default or validate per-row seeds against the request's row count."""
    if row_seeds is None:
        return _default_row_seeds(n, seed)
    row_seeds = np.asarray(row_seeds, np.uint32)
    if row_seeds.shape != (n, 2):
        raise ValueError(
            f"row_seeds must have shape ({n}, 2) — one (seed, row-index) "
            f"pair per EEG row; got {row_seeds.shape}")
    return row_seeds


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser over uint64 (wrapping arithmetic)."""
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _row_keys(row_seeds, domain: int) -> np.ndarray:
    """(B, 2) (seed, row) pairs → (B,) int64 keys of
    ``ops/ddpm.py::row_noise``, namespaced by ``domain`` (0 = prior
    sampling, 1 = SDXL generation): a pure function of (seed, row, domain).
    The JAX package folds the same triple into threefry keys, whose bits
    cannot be reproduced here; the port hashes it with splitmix64."""
    rs = np.asarray(row_seeds, np.uint64).reshape(-1, 2)
    k = _mix64(_mix64(_mix64(rs[:, 0]) ^ rs[:, 1]) ^ np.uint64(domain))
    return k.view(np.int64)


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

    def warmup(self, eeg_shape: tuple[int, int],
               ks: tuple[int, ...] = ()) -> None:
        """One dummy dispatch per bucket over ``eeg_shape=(C, T)`` before
        accepting traffic, so the kernel build and the library handles are
        paid before the first request. Every k ≤ ``k_cap`` shares the
        top-``k_cap`` path; a k above ``k_cap`` in ``ks`` also runs the
        full-ranking path once per bucket."""
        c, t = eeg_shape
        full = [k for k in ks if k > self.k_cap][:1]
        for b in self.buckets:
            for k in (1, *full):
                self.top_k(np.zeros((b, c, t), np.float32),
                           np.zeros(b, np.int32), k=k)

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


class ReconstructionService:
    """EEG epochs → images (the reference's reconstruction pipeline as a
    service) on ``device`` (default: the CUDA card; raises without one).

    ``model``: an eval-mode ``ContrastiveModel`` (``build_encoder``);
    ``prior_pipe``: a trained or loaded ``train/prior.py::PriorPipe``;
    ``generator``: a ``gen/sdxl.py::Generator4Embeds`` with weights, all on
    the same device. Each chunk of ``max_batch`` rows (the last one padded
    up, as the JAX service pads) runs encoder → prior CFG sampling → the
    UNet steps → the VAE decode, and the images are read back once after
    the loop. The JAX service's ``fused=`` switch chooses how XLA schedules
    the three stages (one jitted program or three); eager PyTorch has one
    path, so it has no counterpart here.

    On a CUDA device ``stage_ms`` holds the device milliseconds of the last
    call's stages, summed over its chunks (CUDA events): ``encoder``,
    ``prior``, ``unet_steps`` and ``vae_decode``. The host's side of the
    same stages are spans (``utils/profiling.py``) between the same marks:
    ``recon.encoder``, ``recon.prior``, ``recon.unet`` and ``recon.vae`` a
    chunk, then ``recon.readback`` (the images' one read of the device)."""

    STAGES = ("encoder", "prior", "unet_steps", "vae_decode")

    def __init__(self, model: torch.nn.Module, prior_pipe, generator, *,
                 max_batch: int = 16, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.prior = prior_pipe
        self.generator = generator
        self.max_batch = max_batch
        self.stage_ms: dict[str, float] = {}

    def warmup(self, eeg_shape: tuple[int, int]) -> None:
        """One chunk before accepting traffic: the kernel build, cuDNN's
        algorithm choice and the allocator's pools are paid here."""
        c, t = eeg_shape
        self.reconstruct(np.zeros((1, c, t), np.float32),
                         np.zeros(1, np.int32))

    @torch.inference_mode()
    def _chunk(self, eeg: np.ndarray, sids: np.ndarray,
               row_seeds: np.ndarray, events: list) -> torch.Tensor:
        dev = self.device
        events.append([])
        _mark(dev, events)
        # _prior_embeddings' two steps, each a span
        with profiling.span("recon.encoder"):
            feats, _ = self.model(torch.from_numpy(eeg).to(dev),
                                  torch.from_numpy(sids).to(dev))
        _mark(dev, events)
        with profiling.span("recon.prior"):
            embeds = self.prior.generate(
                feats.float(), row_keys=torch.from_numpy(
                    _row_keys(row_seeds, PRIOR_DOMAIN)).to(dev))
        _mark(dev, events)
        with profiling.span("recon.unet"):
            latents = self.generator.generate(
                embeds, decode=False,
                row_keys=torch.from_numpy(_row_keys(row_seeds, SDXL_DOMAIN)))
        _mark(dev, events)
        with profiling.span("recon.vae"):
            imgs = self.generator.decode(latents)
        _mark(dev, events)
        return imgs

    def reconstruct(self, eeg: np.ndarray, subject_ids: np.ndarray | int, *,
                    seed: int = 0, row_seeds: np.ndarray | None = None
                    ) -> np.ndarray:
        """(B, C, T) EEG → (B, H, W, 3) float32 images in [0, 1].

        Noise is drawn per ROW from ``row_seeds`` ((B, 2) uint32 (seed,
        row-index) pairs; default ``(seed, 0..B-1)``), so the same request
        and seed give the same images alone, coalesced, or split across
        chunks."""
        out, events = [], []
        for chunk, m in _padded_chunks(eeg, subject_ids, row_seeds, seed,
                                       self.max_batch):
            # device results stay queued; one readback after the loop
            out.append(self._chunk(*chunk, events)[:m])
        with profiling.span("recon.readback"):
            images = torch.cat(out).cpu().numpy()
        if self.device.type == "cuda":
            self.stage_ms = _stage_ms(self.STAGES, events)
        return images


class CaptionService:
    """EEG epochs → caption strings (the reference's semantic-level
    pipeline as a service) on ``device`` (default: the CUDA card; raises
    without one).

    ``model``: an eval-mode ``ContrastiveModel``; ``prior_pipe``: a trained
    or loaded ``PriorPipe``; ``captioner``: a ``GITCaptioner`` and
    ``projector``: a ``PixelProjector``, both with weights; ``tokenizer``: a
    ``WordPieceTokenizer``. Each chunk of ``max_batch`` rows (the last one
    padded up, as the JAX service pads) runs encoder → prior CFG sampling
    (per-row keys in ``PRIOR_DOMAIN``, the reconstruction service's) →
    projector → greedy decode; the token ids are read back once after the
    loop. On a CUDA device ``stage_ms`` holds the device milliseconds of
    the last call's stages, summed over its chunks (CUDA events):
    ``encoder``, ``prior``, ``projector`` and ``decode``."""

    STAGES = ("encoder", "prior", "projector", "decode")

    def __init__(self, model: torch.nn.Module, prior_pipe, captioner,
                 projector, tokenizer, *, max_batch: int = 32,
                 max_new_tokens: int = 25,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.prior = prior_pipe
        self.captioner = captioner.to(self.device).eval()
        self.projector = projector.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_new_tokens = max_new_tokens
        self.stage_ms: dict[str, float] = {}

    def warmup(self, eeg_shape: tuple[int, int]) -> None:
        """One chunk before accepting traffic (see
        :meth:`ReconstructionService.warmup`)."""
        c, t = eeg_shape
        self.caption(np.zeros((1, c, t), np.float32), np.zeros(1, np.int32))

    @torch.inference_mode()
    def _chunk(self, eeg: np.ndarray, sids: np.ndarray,
               row_seeds: np.ndarray, events: list) -> torch.Tensor:
        dev = self.device
        events.append([])
        _mark(dev, events)
        embeds = _prior_embeddings(self.model, self.prior, eeg, sids,
                                   row_seeds, dev, events)
        _mark(dev, events)
        grids = self.projector(embeds)
        _mark(dev, events)
        tokens = self.captioner.generate(grids,
                                         max_new_tokens=self.max_new_tokens)
        _mark(dev, events)
        return tokens

    def tokens(self, eeg: np.ndarray, subject_ids: np.ndarray | int, *,
               seed: int = 0, row_seeds: np.ndarray | None = None
               ) -> np.ndarray:
        """(B, C, T) EEG → (B, buffer) int64 GIT token ids: BOS, the greedy
        ids, EOS, then ``pad_token_id``. The prior's noise is per ROW (see
        :meth:`ReconstructionService.reconstruct`) and the decode is
        greedy, so the same request and seed give the same ids alone,
        coalesced or split across chunks."""
        out, events = [], []
        for chunk, m in _padded_chunks(eeg, subject_ids, row_seeds, seed,
                                       self.max_batch):
            out.append(self._chunk(*chunk, events)[:m])
        tokens = torch.cat(out).cpu().numpy()
        if self.device.type == "cuda":
            self.stage_ms = _stage_ms(self.STAGES, events)
        return tokens

    def caption(self, eeg: np.ndarray, subject_ids: np.ndarray | int, *,
                seed: int = 0, row_seeds: np.ndarray | None = None
                ) -> list[str]:
        """(B, C, T) EEG → B caption strings (:meth:`tokens`, decoded)."""
        return [self.tokenizer.decode(row) for row in self.tokens(
            eeg, subject_ids, seed=seed, row_seeds=row_seeds)]


def _padded_chunks(eeg, subject_ids, row_seeds, seed: int, max_batch: int):
    """Validate a request and yield ((eeg, sids, row_seeds) padded to
    ``max_batch`` rows, real rows) per chunk: every chunk has one shape."""
    eeg, subject_ids = _check_request(eeg, subject_ids)
    n = eeg.shape[0]
    row_seeds = _check_row_seeds(row_seeds, n, seed)
    for start in range(0, n, max_batch):
        sl = slice(start, start + max_batch)
        m = eeg[sl].shape[0]
        pad = max_batch - m
        yield (np.pad(eeg[sl], ((0, pad), (0, 0), (0, 0))),
               np.pad(subject_ids[sl], (0, pad)),
               np.pad(row_seeds[sl], ((0, pad), (0, 0)))), m


def _prior_embeddings(model, prior, eeg: np.ndarray, sids: np.ndarray,
                      row_seeds: np.ndarray, dev: torch.device,
                      events: list) -> torch.Tensor:
    """The encoder's eval forward (an event after it), then the prior's CFG
    sampling with per-row keys in ``PRIOR_DOMAIN``: the CLIP embeddings of
    a chunk, shared by the reconstruction and caption services."""
    feats, _ = model(torch.from_numpy(eeg).to(dev),
                     torch.from_numpy(sids).to(dev))
    _mark(dev, events)
    return prior.generate(feats.float(), row_keys=torch.from_numpy(
        _row_keys(row_seeds, PRIOR_DOMAIN)).to(dev))


def _mark(dev: torch.device, events: list) -> None:
    """A CUDA event into the current chunk's list (nothing off the card)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)


def _stage_ms(stages: tuple, events: list) -> dict[str, float]:
    """Device ms of each stage, summed over the chunks' event lists."""
    return {name: float(sum(ev[i].elapsed_time(ev[i + 1]) for ev in events))
            for i, name in enumerate(stages)}
