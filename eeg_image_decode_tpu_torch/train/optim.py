"""Adam in optax's arithmetic, for the diffusion prior's and the low-level
trainer's optimizers (the JAX trainers build theirs from optax).

:class:`OptaxAdam` is ``optax.chain([clip_by_global_norm(max_norm)],
scale_by_adam(b1, b2, eps), [add_decayed_weights(weight_decay)],
scale_by_learning_rate(schedule))`` step for step:

- the clip is g · max/‖g‖ applied as ``(g / ‖g‖) · max`` when ‖g‖ ≥ max,
  else g unchanged (``torch.nn.utils.clip_grad_norm_`` divides by
  ‖g‖ + 1e-6 instead);
- μ ← (1−β₁)·g + β₁·μ, ν ← (1−β₂)·g² + β₂·ν, u = μ̂ / (√ν̂ + ε) with
  μ̂ = μ / (1 − β₁ᶜ), ν̂ = ν / (1 − β₂ᶜ), c the update count from 1;
- decoupled weight decay adds wd·p to u (``torch.optim.AdamW`` scales p by
  1 − lr·wd first);
- p ← p − lr·u with lr = ``schedule(k)`` for the k-th update from 0.

The schedule is a host function of the update count, which the optimizer
keeps in its ``state_dict`` (``param_groups[0]["count"]``), so nothing in a
step reads a device value back and a checkpoint resumes the schedule.
"""

from __future__ import annotations

from typing import Callable

import torch


class OptaxAdam(torch.optim.Optimizer):
    def __init__(self, params, schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_norm: float | None = None):
        super().__init__(params, {"b1": b1, "b2": b2, "eps": eps,
                                  "weight_decay": weight_decay,
                                  "max_norm": max_norm, "count": 0})
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdam takes one parameter group")
        self.schedule = schedule
        #: the global gradient norm of the last step (a device scalar; set
        #: when ``max_norm`` is)
        self.last_grad_norm: torch.Tensor | None = None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam.step takes no closure")
        group = self.param_groups[0]
        params = list(group["params"])
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise RuntimeError("every parameter needs a gradient")
        b1, b2 = group["b1"], group["b2"]
        if group["max_norm"] is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            self.last_grad_norm = norm
            keep = norm < group["max_norm"]
            # g / 1 · 1 is g exactly: below the limit the gradient passes
            grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0,
                                                   group["max_norm"]))
        mu, nu = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            mu.append(st["mu"])
            nu.append(st["nu"])
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        k = group["count"]
        group["count"] = k + 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** (k + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(mu, 1.0 - b1 ** (k + 1))
        torch._foreach_div_(upd, denom)
        if group["weight_decay"]:
            torch._foreach_add_(upd, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, upd, alpha=-float(self.schedule(k)))
