"""Zero-shot k-way retrieval evaluation (counterpart of
``eeg_image_decode_tpu/train/evaluator.py``; ref
``Retrieval/ATMS_retrieval.py:296-357``), vectorised:

- one (N, D) @ (D, n_cls) product for all logits;
- full n_cls-way top-1/top-5 by argmax and top-k;
- sampled k-way by the Gumbel-top-k trick: per sample, Gumbel noise over the
  classes with the true class forced in; the top-k noise positions are the
  candidate set, a uniform draw of k−1 distractors without replacement.

The noise comes from a ``torch.Generator``, or is passed in (``noise=``):
JAX's and PyTorch's generators give different numbers, so a test hands the
same draw to both sides. Following the reference, top-5 is computed only for
k ≥ 50 (``:397-402``).
"""

from __future__ import annotations

import torch


def gumbel_noise(shape: tuple[int, ...], generator: torch.Generator | None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws, −log(−log U) with U uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2.0**-24)))


def kway_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int, *,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None,
                  top5: bool | None = None) -> dict[str, torch.Tensor]:
    """Top-1 (and top-5) accuracy of k-way retrieval.

    ``logits``: (N, n_cls) similarity of each test sample to every class
    image; ``labels``: (N,) true class ids. ``k == n_cls`` is the
    deterministic full protocol; ``k < n_cls`` draws the distractor sets
    from ``noise`` (N, n_cls) or, without it, from ``generator``."""
    n, n_cls = logits.shape
    labels = labels.long()
    if top5 is None:
        top5 = k >= 50
    if k == n_cls:
        out = {"top1": (logits.argmax(1) == labels).float().mean()}
        if top5:
            top5_idx = torch.topk(logits, 5, dim=1).indices
            out["top5"] = (top5_idx == labels[:, None]).any(1).float().mean()
        return out
    if noise is None:
        noise = gumbel_noise((n, n_cls), generator, logits.device)
    g = noise.to(logits.device, torch.float32).clone()
    g[torch.arange(n, device=g.device), labels] = float("inf")
    sel = torch.topk(g, k, dim=1).indices                   # (N, k)
    sel_logits = torch.gather(logits, 1, sel)
    pred = torch.gather(sel, 1, sel_logits.argmax(1, keepdim=True))[:, 0]
    out = {"top1": (pred == labels).float().mean()}
    if top5:
        idx = torch.topk(sel_logits, 5, dim=1).indices
        top_classes = torch.gather(sel, 1, idx)
        out["top5"] = (top_classes == labels[:, None]).any(1).float().mean()
    return out


def retrieval_eval(eeg_features: torch.Tensor,
                   class_img_features: torch.Tensor, labels: torch.Tensor,
                   logit_scale: torch.Tensor | float = 1.0,
                   ks: tuple[int, ...] = (2, 4, 10, 50, 100, 200), *,
                   generator: torch.Generator | None = None,
                   noise: dict[int, torch.Tensor] | None = None
                   ) -> dict[str, torch.Tensor]:
    """The full evaluation protocol at every k ≤ n_cls. ``noise`` maps k to
    its (N, n_cls) Gumbel draw; a missing k draws from ``generator``. The
    scale changes no argmax; it mirrors the reference's logits (``:306``)."""
    n_cls = class_img_features.shape[0]
    logits = logit_scale * torch.matmul(eeg_features.float(),
                                        class_img_features.float().T)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        if k > n_cls:
            continue
        accs = kway_accuracy(logits, labels, k, generator=generator,
                             noise=(noise or {}).get(k))
        out[f"top1_k{k}"] = accs["top1"]
        if "top5" in accs:
            out[f"top5_k{k}"] = accs["top5"]
    return out
