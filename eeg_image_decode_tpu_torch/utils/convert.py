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

``export_atms_state_dict`` / ``convert_atms_state_dict`` take the port's
``state_dict`` to the reference's ``ATMS_retrieval.py`` layout and back
(the JAX ``utils/convert.py`` maps of the same names, written against the
port's keys).
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


# ——— the reference's ``ATMS_retrieval.py`` state_dict layout ———


def _torch_positional_pe(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The reference ``PositionalEmbedding``'s persistent ``pe`` buffer
    (``models/subject_layers/Embed.py:8-23``): deterministic, but a
    ``strict=True`` load requires the key."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]  # (1, max_len, d_model)


def export_atms_state_dict(state_dict: dict, *, num_subjects: int = 2
                           ) -> dict[str, np.ndarray]:
    """The port's ATM-S ``state_dict`` → a reference-format torch
    ``state_dict`` (numpy values) that the reference's ``ATMS`` class loads
    with ``load_state_dict`` (default strict): the inverse of
    :func:`convert_atms_state_dict`, equal key for key and array for array
    to the JAX ``export_atms_state_dict`` of the same weights.

    Dense weights are transposed back to torch's (out, in); the three
    tsconv kernels go back to conv layouts. The one difference of
    representation: on import the conv-before-BatchNorm biases fold into
    the BatchNorm means (``BN(x + b) = BN'(x)``, ``mean' = mean − b``); the
    export writes those biases as zeros beside the current means, the same
    function. The reference registers parameters its forward never uses
    (``subject_wise_linear.{i}``, sized by ``num_subjects``: 2 in the
    retrieval script, 10 in the joint script; ``temporal_embedding``,
    ``mask_token``, ``mask_embedding``) and the deterministic
    ``position_embedding.pe``; strict loading needs them, so they are
    written (zeros, and the exact sinusoid). A joint-trained model's
    per-subject value embeddings go to the joint script's
    ``value_embedding.{sid}`` layout."""
    p = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    e = "encoder."
    sd: dict = {"logit_scale": p["logit_scale.logit_scale"]}

    def put_linear(name, prefix):
        sd[f"{name}.weight"] = np.ascontiguousarray(p[f"{prefix}.kernel"].T)
        sd[f"{name}.bias"] = p[f"{prefix}.bias"]

    def put_ln(name, prefix):
        sd[f"{name}.weight"] = p[f"{prefix}.scale"]
        sd[f"{name}.bias"] = p[f"{prefix}.bias"]

    def put_bn(name, prefix):
        put_ln(name, prefix)
        sd[f"{name}.running_mean"] = p[f"{prefix}.mean"]
        sd[f"{name}.running_var"] = p[f"{prefix}.var"]
        sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

    emb = "encoder.enc_embedding"
    if f"{e}embedding.value_embedding.kernel" in p:
        put_linear(f"{emb}.value_embedding", f"{e}embedding.value_embedding")
        seq_len, d_model = p[f"{e}embedding.value_embedding.kernel"].shape
    else:  # joint-trained: the per-subject ModuleDict layout
        w = p[f"{e}embedding.subject_value_w"]  # (S, seq_len, d_model)
        b = p[f"{e}embedding.subject_value_b"]
        for sid in range(w.shape[0]):
            sd[f"{emb}.value_embedding.{sid}.weight"] = (
                np.ascontiguousarray(w[sid].T))
            sd[f"{emb}.value_embedding.{sid}.bias"] = b[sid]
        seq_len, d_model = w.shape[1:]
    tok = f"{e}embedding.subject_token"
    sd[f"{emb}.subject_embedding.subject_embedding.weight"] = (
        p[f"{tok}.subject_embedding"])
    sd[f"{emb}.subject_embedding.shared_embedding"] = (
        p[f"{tok}.shared_embedding"])
    sd[f"{emb}.subject_embedding.mask_embedding"] = np.zeros(
        (1, d_model), np.float32)
    sd[f"{emb}.mask_token"] = np.zeros((1, d_model), np.float32)
    sd[f"{emb}.position_embedding.pe"] = _torch_positional_pe(d_model)
    # timeF temporal embedding (freq 'h' → 4 inputs), never fed
    sd[f"{emb}.temporal_embedding.embed.weight"] = np.zeros(
        (d_model, 4), np.float32)

    i = 0
    while f"{e}encoder_layer_{i}.q_proj.kernel" in p:
        q, layer = f"encoder.encoder.attn_layers.{i}", f"{e}encoder_layer_{i}"
        for ref, ours in (("query_projection", "q_proj"),
                          ("key_projection", "k_proj"),
                          ("value_projection", "v_proj"),
                          ("out_projection", "out_proj")):
            put_linear(f"{q}.attention.{ref}", f"{layer}.{ours}")
        # Dense kernel (in, out) → 1x1 Conv1d weight (out, in, 1)
        for ref, ours in (("conv1", "ffn_in"), ("conv2", "ffn_out")):
            sd[f"{q}.{ref}.weight"] = np.ascontiguousarray(
                p[f"{layer}.{ours}.kernel"].T[:, :, None])
            sd[f"{q}.{ref}.bias"] = p[f"{layer}.{ours}.bias"]
        put_ln(f"{q}.norm1", f"{layer}.norm1")
        put_ln(f"{q}.norm2", f"{layer}.norm2")
        i += 1
    put_ln("encoder.encoder.norm", f"{e}encoder_norm")

    # the forward-commented subject_wise_linear stack
    # (ATMS_retrieval.py:177,187): zeros satisfy strict loading
    for s in range(num_subjects):
        sd[f"subject_wise_linear.{s}.weight"] = np.zeros((seq_len, d_model),
                                                         np.float32)
        sd[f"subject_wise_linear.{s}.bias"] = np.zeros((seq_len,), np.float32)

    enc = f"{e}enc_eeg"
    w_t = p[f"{enc}.temporal_conv_kernel"]  # (K, F)
    n_f = w_t.shape[1]
    sd["enc_eeg.0.tsconv.0.weight"] = np.ascontiguousarray(
        w_t.T[:, None, None, :])  # (F, 1, 1, K)
    # the bias folded into bn1's mean at import (or never existed for a
    # model trained here): zero bias + the current mean is the same function
    sd["enc_eeg.0.tsconv.0.bias"] = np.zeros((n_f,), np.float32)
    put_bn("enc_eeg.0.tsconv.2", f"{enc}.bn1")
    w_s = p[f"{enc}.spatial_conv.kernel"]  # (C·F, G), c-major rows
    n_c, n_g = w_s.shape[0] // n_f, w_s.shape[1]
    sd["enc_eeg.0.tsconv.4.weight"] = np.ascontiguousarray(
        w_s.reshape(n_c, n_f, n_g).transpose(2, 1, 0)[..., None])  # (G,F,C,1)
    sd["enc_eeg.0.tsconv.4.bias"] = np.zeros((n_g,), np.float32)
    put_bn("enc_eeg.0.tsconv.5", f"{enc}.bn2")
    sd["enc_eeg.0.projection.0.weight"] = np.ascontiguousarray(
        p[f"{enc}.proj_conv.kernel"].T[:, :, None, None])  # (E, F, 1, 1)
    sd["enc_eeg.0.projection.0.bias"] = p[f"{enc}.proj_conv.bias"]

    put_linear("proj_eeg.0", f"{e}proj_eeg.in_proj")
    put_linear("proj_eeg.1.fn.1", f"{e}proj_eeg.res_proj")
    put_ln("proj_eeg.2", f"{e}proj_eeg.ln")
    return sd


def reference_atms_config(**overrides):
    """``ATMSConfig`` for weights converted from the reference: its
    attention FFN uses exact-erf GELU (``Transformer_EncDec.py:33-41``),
    where the port's default is tanh GELU (what the attention kernel
    computes)."""
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig

    overrides.setdefault("exact_gelu", True)
    return ATMSConfig(**overrides)


def convert_atms_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """A reference ATMS ``state_dict`` (tensors or numpy arrays) → the
    port's ``state_dict`` for ``build_encoder("atms")`` (fp32), loaded with
    ``strict=True``. The conv-before-BatchNorm biases fold into the
    BatchNorm means. The port's tree is the same under either
    ``fused_tsconv`` (stage 1 always holds ``temporal_conv_kernel``), so
    the JAX function's ``fused_tsconv`` argument has no counterpart here.
    The reference's unused parameters and buffers are not read."""
    sd = {k: (v.detach().cpu().float().numpy() if torch.is_tensor(v)
              else np.asarray(v, np.float32)) for k, v in sd.items()}
    out: dict = {"logit_scale.logit_scale": sd["logit_scale"]}
    e, emb = "encoder.", "encoder.enc_embedding"

    def linear(ours, ref):
        out[f"{ours}.kernel"] = sd[f"{ref}.weight"].T
        out[f"{ours}.bias"] = sd[f"{ref}.bias"]

    def ln(ours, ref):
        out[f"{ours}.scale"] = sd[f"{ref}.weight"]
        out[f"{ours}.bias"] = sd[f"{ref}.bias"]

    def bn(ours, ref, shift):
        ln(ours, ref)
        out[f"{ours}.mean"] = sd[f"{ref}.running_mean"] - shift
        out[f"{ours}.var"] = sd[f"{ref}.running_var"]

    linear(f"{e}embedding.value_embedding", f"{emb}.value_embedding")
    out[f"{e}embedding.subject_token.subject_embedding"] = sd[
        f"{emb}.subject_embedding.subject_embedding.weight"]
    out[f"{e}embedding.subject_token.shared_embedding"] = sd[
        f"{emb}.subject_embedding.shared_embedding"]
    i = 0
    while f"encoder.encoder.attn_layers.{i}.conv1.weight" in sd:
        q, layer = f"encoder.encoder.attn_layers.{i}", f"{e}encoder_layer_{i}"
        for ref, ours in (("query_projection", "q_proj"),
                          ("key_projection", "k_proj"),
                          ("value_projection", "v_proj"),
                          ("out_projection", "out_proj")):
            linear(f"{layer}.{ours}", f"{q}.attention.{ref}")
        # the FFN's two 1x1 Conv1d (out, in, 1) → Dense kernels (in, out)
        for ref, ours in (("conv1", "ffn_in"), ("conv2", "ffn_out")):
            out[f"{layer}.{ours}.kernel"] = sd[f"{q}.{ref}.weight"][:, :, 0].T
            out[f"{layer}.{ours}.bias"] = sd[f"{q}.{ref}.bias"]
        ln(f"{layer}.norm1", f"{q}.norm1")
        ln(f"{layer}.norm2", f"{q}.norm2")
        i += 1
    ln(f"{e}encoder_norm", "encoder.encoder.norm")

    enc, ts = f"{e}enc_eeg", "enc_eeg.0.tsconv"
    out[f"{enc}.temporal_conv_kernel"] = sd[f"{ts}.0.weight"][:, 0, 0, :].T
    bn(f"{enc}.bn1", f"{ts}.2", sd[f"{ts}.0.bias"])
    w_s = sd[f"{ts}.4.weight"]  # (G, F, C, 1)
    out[f"{enc}.spatial_conv.kernel"] = (
        w_s[..., 0].transpose(2, 1, 0).reshape(-1, w_s.shape[0]))
    bn(f"{enc}.bn2", f"{ts}.5", sd[f"{ts}.4.bias"])
    out[f"{enc}.proj_conv.kernel"] = sd[
        "enc_eeg.0.projection.0.weight"][:, :, 0, 0].T
    out[f"{enc}.proj_conv.bias"] = sd["enc_eeg.0.projection.0.bias"]
    linear(f"{e}proj_eeg.in_proj", "proj_eeg.0")
    linear(f"{e}proj_eeg.res_proj", "proj_eeg.1.fn.1")
    ln(f"{e}proj_eeg.ln", "proj_eeg.2")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
