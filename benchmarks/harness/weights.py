"""Weights made on the device from the seed, the same values on every side
that asks for them: the program's modules are filled in place, the
reference's float32 copies from the same draws."""

from __future__ import annotations

import math
import zlib

import torch

#: elements drawn per call
CHUNK = 1 << 28
#: the raw logit scale's initial value, ln(1/0.07)
LOGIT_SCALE = 2.6592600225


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed (splitmix64
    of the seed and the tag's CRC)."""
    mask = (1 << 64) - 1
    z = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def _value(name: str, z: torch.Tensor) -> torch.Tensor:
    """A leaf's values from its standard normals, by the kind its name and
    shape say: LeCun-normal kernels and weights (fan-in the input axes),
    unit-variance embeddings, norm scales 1 + N(0, 0.1²), biases
    N(0, 0.02²), BatchNorm means N(0, 0.1²) and variances exp(N(0, 0.2²)),
    the logit scale ln(1/0.07)."""
    leaf = name.rsplit(".", 1)[-1]
    shape = z.shape
    if leaf == "logit_scale":
        return torch.full_like(z, LOGIT_SCALE)
    if leaf == "mean":
        return 0.1 * z
    if leaf == "var":
        return torch.exp(0.2 * z)
    if leaf.endswith("embedding"):
        return z
    if leaf == "subject_value_w":
        return z / math.sqrt(shape[1])
    if leaf.endswith("kernel") and z.ndim >= 2:
        return z / math.sqrt(math.prod(shape[:-1]))
    if leaf == "weight" and z.ndim >= 2:
        return z / math.sqrt(math.prod(shape[1:]))
    if leaf in ("weight", "scale"):
        return 1.0 + 0.1 * z
    return 0.02 * z


@torch.no_grad()
def fill_(named, seed: int, tag: str, *, round_to: dict | None = None
          ) -> None:
    """Fill the tensors of ``named`` ((name, tensor) pairs, all on one
    device) in place, in order, from one generator seeded by (seed, tag),
    drawn in calls of at most :data:`CHUNK` elements. ``round_to`` (name →
    dtype) rounds a leaf's values through that dtype first, so a float32
    copy holds what a bfloat16 leaf holds."""
    named = list(named)
    if not named:
        return
    dev = named[0][1].device
    g = torch.Generator(device=dev).manual_seed(derive_seed(seed, tag))
    round_to = round_to or {}
    i = 0
    while i < len(named):
        j, total = i, 0
        while j < len(named) and (j == i or
                                  total + named[j][1].numel() <= CHUNK):
            total += named[j][1].numel()
            j += 1
        z = torch.randn(total, generator=g, device=dev)
        off = 0
        for name, t in named[i:j]:
            v = _value(name, z[off:off + t.numel()].view(t.shape))
            if name in round_to:
                v = v.to(round_to[name])
            t.copy_(v)
            off += t.numel()
        del z
        i = j


def check_names(expected, state: dict, what: str) -> None:
    """Raise unless ``state`` (a state dict) holds exactly the expected
    (name, shape) pairs."""
    want = {n: tuple(s) for n, s in expected}
    got = {n: tuple(t.shape) for n, t in state.items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise ValueError(f"{what}: the configuration's leaves differ from "
                         f"the program's: missing {missing[:5]}, extra "
                         f"{extra[:5]}, shapes {wrong[:5]}")
