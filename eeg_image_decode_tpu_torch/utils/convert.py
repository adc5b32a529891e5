"""Weights from the JAX package into the port.

``params_from_flax`` takes the JAX package's ATM-S variable tree
(``{"params": …, "batch_stats": …}`` as nested dicts of numpy arrays, the
model built with ``build_encoder("atms")``) and returns the port's
``state_dict``. The port keeps the JAX names and the (d_in, d_out)
layout of dense kernels, so a key is the flax path joined with ``.``; the
only layout changes are the three conv kernels of the tsconv stack, and they
live here and nowhere else:

- ``temporal_conv/kernel`` (1, K, 1, F) HWIO → ``temporal_conv_kernel``
  (K, F) (the JAX fused-stage-1 tree already stores it so);
- ``spatial_conv/kernel`` (C, 1, F, G) HWIO → (C·F, G), c-major rows;
- ``proj_conv/kernel`` (1, 1, F, E) → (F, E).

A joint-training model (``ATMSConfig(joint_train=True)``) has
``embedding/subject_value_w`` (subjects, T, d_model) and
``embedding/subject_value_b`` in place of ``embedding/value_embedding``, in
both packages under the same names and layouts.

``save_flat_npz`` / ``load_flat_npz`` store the same tree in one ``.npz``
with ``/``-joined keys (``params/encoder/embedding/…``): the weight file of
the CLI's ``serve --weights``.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "", sep: str = "/") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key, sep))
        else:
            out[key] = np.asarray(v)
    return out


def _port_layout(key: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    if key.endswith("temporal_conv.kernel"):
        return key[: -len(".kernel")] + "_kernel", a.reshape(a.shape[1], -1)
    if key.endswith("spatial_conv.kernel"):
        c, _, f, g = a.shape
        return key, a.reshape(c * f, g)
    if key.endswith("proj_conv.kernel"):
        return key, a.reshape(a.shape[-2], a.shape[-1])
    return key, a


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ATM-S variables → the port's ``state_dict`` (fp32 tensors).

    Load it with ``model.load_state_dict(sd, strict=True)`` into
    ``build_encoder("atms")`` of the same configuration."""
    flat = _flatten(variables.get("params", {}), sep=".")
    flat.update(_flatten(variables.get("batch_stats", {}), sep="."))
    sd = {}
    for key, a in flat.items():
        key, a = _port_layout(key, a)
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))
    return sd


def save_flat_npz(variables: dict, path: str) -> None:
    """The JAX variable tree (nested dicts of arrays) → one ``.npz``."""
    np.savez(path, **_flatten(variables))


def load_flat_npz(path: str) -> dict:
    """Inverse of :func:`save_flat_npz`: the nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
