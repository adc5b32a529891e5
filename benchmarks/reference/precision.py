"""Operand rounding of the reference's products, for the correctness
control: in float32 (the default) the reference is the function the
configuration states; under :func:`fp8` every product computes as FP8
training does, one step below bfloat16: its forward operands rounded to
e4m3 and, in the backward, the gradient that reaches it rounded to e5m2,
each with one scale per tensor (its largest magnitude at the format's
largest finite value)."""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

_ROUNDING = contextvars.ContextVar("operand_rounding", default=False)


_FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8_round(t: torch.Tensor,
              fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under a per-tensor scale, in t's dtype."""
    scale = (t.detach().abs().amax().float() / _FORMATS[fmt]).clamp(
        min=1e-30)
    return ((t.float() / scale).to(fmt).float() * scale).to(t.dtype)


class _Operand(torch.autograd.Function):
    """Forward: e4m3; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """Forward: unchanged; the gradient reaching the product: e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's operand as the active rounding leaves it."""
    return _Operand.apply(t) if _ROUNDING.get() else t


def product(t: torch.Tensor) -> torch.Tensor:
    """A product's result, whose gradient the active rounding rounds."""
    return _Product.apply(t) if _ROUNDING.get() else t


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return product(torch.matmul(operand(a), operand(b)))


@contextlib.contextmanager
def fp8():
    """Every :func:`mm` and :func:`operand` in the block rounds to e4m3."""
    token = _ROUNDING.set(True)
    try:
        yield
    finally:
        _ROUNDING.reset(token)


@torch.no_grad()
def round_modules_fp8(module: nn.Module) -> nn.Module:
    """The control of a module tree built of ``nn.Linear`` / ``nn.Conv2d``:
    their weights rounded to e4m3 in place and their inputs on every
    call."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.copy_(fp8_round(m.weight))
            m.register_forward_pre_hook(
                lambda _m, args: (fp8_round(args[0]), *args[1:]))
    return module
