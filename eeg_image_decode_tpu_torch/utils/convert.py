"""Weights from the JAX package into the port.

``params_from_flax`` takes the JAX package's variable tree of any encoder
of the registry (``{"params": …, "batch_stats": …}`` as nested dicts of
numpy arrays, the model built with ``build_encoder(name)``) and returns the
port's ``state_dict``. The port keeps the JAX names and the (d_in, d_out)
layout of dense kernels, so a key is the flax path joined with ``.``. The
zoo's convolution and attention kernels keep flax's layouts too (HWIO,
(k, in, out), (d, heads, head_dim)); the only layout changes are the three
conv kernels of the tsconv stack of ATM-S and NICE, and they live here and
nowhere else:

- ``temporal_conv/kernel`` (1, K, 1, F) HWIO → ``temporal_conv_kernel``
  (K, F) (the JAX fused-stage-1 tree already stores it so);
- ``spatial_conv/kernel`` (C, 1, F, G) HWIO → (C·F, G), c-major rows;
- ``proj_conv/kernel`` (1, 1, F, E) → (F, E).

The diffusion prior's tree (``models/diffusion_prior.py``) needs no layout
change. The low-level encoder's (``models/lowlevel.py``, ``params`` and
``batch_stats``) computes in NCHW with PyTorch's convolutions:

- ``up_{i}/kernel``, flax ``ConvTranspose`` (kh, kw, in, out), unflipped →
  ``F.conv_transpose2d``'s (in, out, kh, kw), flipped in space (torch's
  transposed convolution is the gradient of a correlation);
- ``proj_16/kernel`` and ``proj_out/kernel``, 1 × 1 ``Conv`` (1, 1, in, out)
  → ``F.conv2d``'s (out, in, 1, 1).

The SDXL generator's tree (``{"unet": …, "vae": …}``, the JAX
``--generator-params`` pickle) maps onto the port's UNet and VAE
(``gen/unet.py``, ``gen/vae.py``), which carry diffusers' names: the flax
module paths are renamed (``down_1_attn_0/block_0`` →
``down_blocks.1.attentions.0.transformer_blocks.0``, …), dense kernels
transposed to (out, in), conv kernels HWIO → OIHW, norm ``scale`` →
``weight``; the keys come back under ``unet.`` and ``vae.``.

:func:`flax_from_params` is the inverse for the trees the port pickles (the
prior's, the low-level encoder's and the generator's). :func:`load_numpy_pickle` reads such
a pickle, or the JAX package's, without importing JAX.

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

The GIT captioner's tree (the JAX ``GITCaptioner`` params, the
``--git-params`` pickle) maps onto the port's decoder, which carries
transformers' ``GitForCausalLM`` names (``git_state_dict_from_flax`` and
back, ``git_tree_from_state_dict``): flax's attention kernels, q/k/v
(d, heads, head_dim) and out (heads, head_dim, d), fold to (d, d) torch
weights. The ``PixelProjector`` tree (the ``--projector-params`` pickle,
what ``train-adapter`` writes) keeps the JAX names
(``pixel_projector_state_dict_from_flax`` and back);
``convert_pixel_projector`` reads the reference's ``Sequential``
(``PixelProjector_best.bin``: indices 1, 2, 4 and 5).

The metric backbones' trees (the JAX ``--backbone-params`` pickle's
``alexnet``, ``inception``, ``effnet`` and ``swav`` entries) map onto the
port's modules of ``eval/backbones.py``, which carry torchvision's names
(``backbone_state_dict_from_flax`` and back,
``backbone_tree_from_state_dict``): flax module paths renamed
(``layer2_0/c/bn`` → ``layer2.0.bn3``, ``stage2_1/dw_conv`` →
``features.2.1.block.1.0``, …), conv kernels HWIO → OIHW, ``FrozenBN``
leaves → BatchNorm's; both refuse a missing or extra key.
"""

from __future__ import annotations

import pickle
import re

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


_CONV_T = re.compile(r"(^|\.)up_\d+\.kernel$")
_CONV_1X1 = re.compile(r"(^|\.)proj_(16|out)\.kernel$")


def _port_layout(key: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    if _CONV_T.search(key):  # (kh, kw, in, out) → flipped (in, out, kh, kw)
        return key, np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
    if _CONV_1X1.search(key):  # (1, 1, in, out) → (out, in, 1, 1)
        return key, np.transpose(a, (3, 2, 0, 1))
    if key.endswith("temporal_conv.kernel"):
        return key[: -len(".kernel")] + "_kernel", a.reshape(a.shape[1], -1)
    if key.endswith("spatial_conv.kernel"):
        c, _, f, g = a.shape
        return key, a.reshape(c * f, g)
    if key.endswith("proj_conv.kernel"):
        return key, a.reshape(a.shape[-2], a.shape[-1])
    return key, a


#: the SDXL generator's flax names → the port's (diffusers') names, applied
#: in order to a dotted module path (the leaf excluded); ``_GEN_BACK`` is
#: the inverse
_UNET_NAMES = [
    (r"^time_embed_(\d+)$", r"time_embedding.linear_\1"),
    (r"^add_embed_(\d+)$", r"add_embedding.linear_\1"),
    (r"^ip_image_proj$", "image_proj.proj"),
    (r"^ip_norm$", "image_proj.norm"),
    (r"^norm_out$", "conv_norm_out"),
    (r"^(down|up)_(\d+)_res_(\d+)", r"\1_blocks.\2.resnets.\3"),
    (r"^(down|up)_(\d+)_attn_(\d+)", r"\1_blocks.\2.attentions.\3"),
    (r"^down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv"),
    (r"^up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0.conv"),
    (r"^mid_res_(\d+)", r"mid_block.resnets.\1"),
    (r"^mid_attn", "mid_block.attentions.0"),
    (r"\.block_(\d+)\.", r".transformer_blocks.\1."),
    (r"\.to_out$", ".to_out.0"),
    (r"\.ff\.proj_in$", ".ff.net.0.proj"),
    (r"\.ff\.proj_out$", ".ff.net.2"),
    (r"\.ip_to_([kv])$", r".to_\1_ip"),
]
_VAE_NAMES = [
    (r"^(encoder|decoder)\.(down|up)_(\d+)_res_(\d+)",
     r"\1.\2_blocks.\3.resnets.\4"),
    (r"^encoder\.down_(\d+)_downsample$",
     r"encoder.down_blocks.\1.downsamplers.0.conv"),
    (r"^decoder\.up_(\d+)_upsample$",
     r"decoder.up_blocks.\1.upsamplers.0.conv"),
    (r"^(encoder|decoder)\.mid_res_(\d+)", r"\1.mid_block.resnets.\2"),
    (r"^(encoder|decoder)\.mid_attn\.norm$",
     r"\1.mid_block.attentions.0.group_norm"),
    (r"^(encoder|decoder)\.mid_attn", r"\1.mid_block.attentions.0"),
    (r"^(encoder|decoder)\.norm_out$", r"\1.conv_norm_out"),
    (r"\.to_out$", ".to_out.0"),
    (r"\.shortcut$", ".conv_shortcut"),
]
_GEN_BACK = {
    "unet": [
        (r"^time_embedding\.linear_(\d+)$", r"time_embed_\1"),
        (r"^add_embedding\.linear_(\d+)$", r"add_embed_\1"),
        (r"^image_proj\.proj$", "ip_image_proj"),
        (r"^image_proj\.norm$", "ip_norm"),
        (r"^conv_norm_out$", "norm_out"),
        (r"^down_blocks\.(\d+)\.downsamplers\.0\.conv$", r"down_\1_downsample"),
        (r"^up_blocks\.(\d+)\.upsamplers\.0\.conv$", r"up_\1_upsample"),
        (r"^(down|up)_blocks\.(\d+)\.resnets\.(\d+)", r"\1_\2_res_\3"),
        (r"^(down|up)_blocks\.(\d+)\.attentions\.(\d+)", r"\1_\2_attn_\3"),
        (r"^mid_block\.resnets\.(\d+)", r"mid_res_\1"),
        (r"^mid_block\.attentions\.0", "mid_attn"),
        (r"\.transformer_blocks\.(\d+)\.", r".block_\1."),
        (r"\.to_out\.0$", ".to_out"),
        (r"\.ff\.net\.0\.proj$", ".ff.proj_in"),
        (r"\.ff\.net\.2$", ".ff.proj_out"),
        (r"\.to_([kv])_ip$", r".ip_to_\1"),
    ],
    "vae": [
        (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv$",
         r"encoder.down_\1_downsample"),
        (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv$",
         r"decoder.up_\1_upsample"),
        (r"^(encoder|decoder)\.(down|up)_blocks\.(\d+)\.resnets\.(\d+)",
         r"\1.\2_\3_res_\4"),
        (r"^(encoder|decoder)\.mid_block\.resnets\.(\d+)", r"\1.mid_res_\2"),
        (r"^(encoder|decoder)\.mid_block\.attentions\.0\.group_norm$",
         r"\1.mid_attn.norm"),
        (r"^(encoder|decoder)\.mid_block\.attentions\.0", r"\1.mid_attn"),
        (r"^(encoder|decoder)\.conv_norm_out$", r"\1.norm_out"),
        (r"\.to_out\.0$", ".to_out"),
        (r"\.conv_shortcut$", ".shortcut"),
    ],
}
_GEN_NAMES = {"unet": _UNET_NAMES, "vae": _VAE_NAMES}


def _rename(path: str, rules) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path


def generator_arrays_from_flax(tree: dict) -> dict[str, np.ndarray]:
    """The JAX generator's ``{"unet": …, "vae": …}`` param tree → the
    port's keys under ``unet.`` / ``vae.`` and numpy views in the port's
    layouts (no copy is made): dense kernels (in, out) → (out, in)
    weights, conv kernels HWIO → OIHW, norm ``scale`` → ``weight``."""
    out = {}
    for part in ("unet", "vae"):
        for key, a in _flatten(tree.get(part, {}), sep=".").items():
            path, leaf = key.rsplit(".", 1)
            if leaf == "kernel":
                a = a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))
            name = f"{part}.{_rename(path, _GEN_NAMES[part])}." + (
                "bias" if leaf == "bias" else "weight")
            out[name] = a
    return out


def _flax_from_generator(state_dict: dict) -> dict:
    out: dict = {}
    for key, v in state_dict.items():
        a = np.array(v.detach().float().cpu().numpy() if torch.is_tensor(v)
                     else v, dtype=np.float32)
        part, rest = key.split(".", 1)
        path, leaf = rest.rsplit(".", 1)
        if leaf == "weight" and a.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf = "kernel"
            a = a.T if a.ndim == 2 else np.transpose(a, (2, 3, 1, 0))
        node = out.setdefault(part, {})
        for p in _rename(path, _GEN_BACK[part]).split("."):
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


#: the encoder a JAX ``ContrastiveModel`` tree holds, told by a top-level
#: name of its ``encoder`` subtree (the first rule that matches)
_ENCODER_MARKS = (
    ("atms", "embedding"), ("atme", "attention"),
    ("eegnetv4", "spatial_depthwise_kernel"), ("mlp", "input_fc_l"),
    ("shallowfbcspnet", "conv_classifier"), ("eegconformer", "block_0"),
    ("metaeeg", "conv_block_0"), ("atcnet", "attn_0"),
    ("eegitnet", "branch0_dw"), ("nice", "enc_eeg"),
)


def encoder_name_of(params: dict) -> str | None:
    """The registry name of the encoder whose JAX ``params`` these are, or
    None for a tree that holds no ``encoder`` (the prior's, the low-level
    encoder's)."""
    enc = params.get("encoder")
    if not isinstance(enc, dict):
        return None
    for name, mark in _ENCODER_MARKS:
        if mark in enc:
            return name
    raise ValueError(f"no known encoder holds {sorted(enc)}")


def params_from_flax(variables: dict,
                     encoder: str | None = None) -> dict[str, torch.Tensor]:
    """JAX variables (any encoder of the registry, the diffusion prior, the
    low-level encoder, or the SDXL generator's ``{"unet": …, "vae": …}``
    tree) → the port's ``state_dict`` (fp32 tensors; the generator's keys
    under ``unet.`` and ``vae.``, in diffusers' names).

    ``encoder`` names the registry encoder (default: told from the tree,
    :func:`encoder_name_of`). The tsconv layout rules apply to ATM-S and
    NICE only: the zoo's other encoders keep flax's kernel layouts in the
    port, and two of their names (EEGNetV4's ``temporal_conv.kernel``,
    EEGConformer's ``proj_conv.kernel``) would match those rules.

    Load it with ``model.load_state_dict(sd, strict=True)`` into the port's
    model of the same configuration."""
    if "unet" in variables or "vae" in variables:
        return {k: torch.from_numpy(np.array(a, dtype=np.float32))
                for k, a in generator_arrays_from_flax(variables).items()}
    params = variables.get("params", {})
    if encoder is None:
        encoder = encoder_name_of(params)
    flat = _flatten(params, sep=".")
    flat.update(_flatten(variables.get("batch_stats", {}), sep="."))
    keep_layout = encoder not in (None, "atms", "nice")
    sd = {}
    for key, a in flat.items():
        if not keep_layout:
            key, a = _port_layout(key, a)
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))
    return sd


def flax_from_params(state_dict: dict) -> dict:
    """The inverse of :func:`params_from_flax` for the diffusion prior's and
    the low-level encoder's ``state_dict``: ``{"params": tree,
    "batch_stats": tree}`` of fp32 numpy arrays in the JAX layouts (BatchNorm
    ``mean`` / ``var`` buffers go to ``batch_stats``). The ATM-S tsconv
    kernels do not map back from their keys alone and are refused. A
    generator ``state_dict`` (keys under ``unet.`` / ``vae.``) maps back to
    the JAX generator's ``{"unet": …, "vae": …}`` tree."""
    if state_dict and all(k.startswith(("unet.", "vae."))
                          for k in state_dict):
        return _flax_from_generator(state_dict)
    out: dict = {"params": {}, "batch_stats": {}}
    for key, v in state_dict.items():
        if key.endswith(("temporal_conv_kernel", "spatial_conv.kernel",
                         "proj_conv.kernel")):
            raise ValueError(f"{key}: the ATM-S tsconv kernels have no "
                             "inverse here")
        a = np.array(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                     dtype=np.float32)
        if _CONV_T.search(key):
            a = np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
        elif _CONV_1X1.search(key):
            a = np.transpose(a, (2, 3, 1, 0))
        *parents, leaf = key.split(".")
        node = out["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy arrays and plain containers only: a pickle that names
    a class of JAX (``jax.Array`` leaves) or of any other package is refused
    before that package is imported."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"the pickle holds {module}.{name} objects (jax.Array "
                "leaves); write it with numpy leaves instead, e.g. "
                "jax.tree_util.tree_map(np.asarray, tree)")
        if root == "numpy" or (module, name) in (
                ("builtins", "dict"), ("builtins", "list"),
                ("builtins", "tuple"), ("collections", "OrderedDict"),
                ("_codecs", "encode")):  # protocol 2 array bytes
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the pickle names {module}.{name}; only numpy arrays in plain "
            "dicts are read")


def load_numpy_pickle(path: str):
    """A pickle of numpy arrays in plain containers (a JAX param tree as
    the JAX package writes it), read without importing JAX."""
    with open(path, "rb") as f:
        return _NumpyOnly(f).load()


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


# ——— the GIT captioner and its PixelProjector (models/git_caption.py) ———


def _np32(v) -> np.ndarray:
    return np.array(v.detach().float().cpu().numpy() if torch.is_tensor(v)
                    else v, dtype=np.float32)


def _dense_ln_from_flax(out: dict, prefix: str, leaf: dict) -> None:
    """A flax Dense (kernel (in, out)) or LayerNorm (scale) leaf → torch
    ``weight`` (out, in) / ``weight`` and ``bias``."""
    if "kernel" in leaf:
        out[f"{prefix}.weight"] = np.asarray(leaf["kernel"]).T
    else:
        out[f"{prefix}.weight"] = leaf["scale"]
    out[f"{prefix}.bias"] = leaf["bias"]


def _dense_ln_to_flax(sd: dict, prefix: str, *, norm: bool) -> dict:
    w = _np32(sd[f"{prefix}.weight"])
    return {"scale" if norm else "kernel":
            w if norm else np.ascontiguousarray(w.T),
            "bias": _np32(sd[f"{prefix}.bias"])}


#: the JAX GIT tree's names → the port's (transformers') module names
_GIT_TOP = {"embed_ln": "git.embeddings.LayerNorm",
            "visual_proj": "git.visual_projection.visual_projection.0",
            "visual_ln": "git.visual_projection.visual_projection.1",
            "lm_head": "output"}
_GIT_LAYER = {"ln_attn": "attention.output.LayerNorm",
              "ff1": "intermediate.dense", "ff2": "output.dense",
              "ln_ff": "output.LayerNorm"}


def git_state_dict_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX ``GITCaptioner`` param tree (nested dicts of numpy arrays)
    → the port decoder's ``state_dict`` (fp32; load it strictly)."""
    out = {"git.embeddings.word_embeddings.weight":
           tree["token_embed"]["embedding"],
           "git.embeddings.position_embeddings.weight":
           tree["pos_embed"]["embedding"]}
    for name, prefix in _GIT_TOP.items():
        _dense_ln_from_flax(out, prefix, tree[name])
    i = 0
    while f"layer_{i}" in tree:
        layer, p = tree[f"layer_{i}"], f"git.encoder.layer.{i}"
        attn = layer["attn"]
        d = np.shape(attn["query"]["kernel"])[0]
        for n in ("query", "key", "value"):
            out[f"{p}.attention.self.{n}.weight"] = np.asarray(
                attn[n]["kernel"]).reshape(d, d).T
            out[f"{p}.attention.self.{n}.bias"] = np.asarray(
                attn[n]["bias"]).reshape(d)
        out[f"{p}.attention.output.dense.weight"] = np.asarray(
            attn["out"]["kernel"]).reshape(d, d).T
        out[f"{p}.attention.output.dense.bias"] = attn["out"]["bias"]
        for name, suffix in _GIT_LAYER.items():
            _dense_ln_from_flax(out, f"{p}.{suffix}", layer[name])
        i += 1
    return {k: torch.from_numpy(_np32(v)) for k, v in out.items()}


def git_tree_from_state_dict(sd: dict, n_heads: int) -> dict:
    """Inverse of :func:`git_state_dict_from_flax`: the port decoder's (or
    a ``GitForCausalLM``'s decoder) ``state_dict`` → the JAX tree, fp32
    numpy (the layout the JAX ``convert_git_causal_lm`` writes)."""
    tree = {"token_embed": {"embedding": _np32(
                sd["git.embeddings.word_embeddings.weight"])},
            "pos_embed": {"embedding": _np32(
                sd["git.embeddings.position_embeddings.weight"])}}
    for name, prefix in _GIT_TOP.items():
        tree[name] = _dense_ln_to_flax(sd, prefix, norm=name.endswith("ln"))
    i = 0
    while f"git.encoder.layer.{i}.intermediate.dense.weight" in sd:
        p = f"git.encoder.layer.{i}"
        d = np.shape(sd[f"{p}.attention.self.query.weight"])[0]
        hd = d // n_heads

        def fold(n):
            return {"kernel": np.ascontiguousarray(_np32(
                        sd[f"{p}.attention.self.{n}.weight"]).T.reshape(
                            d, n_heads, hd)),
                    "bias": _np32(sd[f"{p}.attention.self.{n}.bias"]
                                  ).reshape(n_heads, hd)}

        layer = {"attn": {n: fold(n) for n in ("query", "key", "value")}}
        layer["attn"]["out"] = {
            "kernel": np.ascontiguousarray(_np32(
                sd[f"{p}.attention.output.dense.weight"]).T.reshape(
                    n_heads, hd, d)),
            "bias": _np32(sd[f"{p}.attention.output.dense.bias"])}
        for name, suffix in _GIT_LAYER.items():
            layer[name] = _dense_ln_to_flax(sd, f"{p}.{suffix}",
                                            norm=name.startswith("ln"))
        tree[f"layer_{i}"] = layer
        i += 1
    return tree


_PROJECTOR = ("expand", "ln_tokens", "proj", "ln")


def pixel_projector_state_dict_from_flax(tree: dict
                                         ) -> dict[str, torch.Tensor]:
    """The JAX ``PixelProjector`` params (``expand``, ``ln_tokens``,
    ``proj``, ``ln``) → the port's ``state_dict`` (fp32; load strictly)."""
    out: dict = {}
    for name in _PROJECTOR:
        _dense_ln_from_flax(out, name, tree[name])
    return {k: torch.from_numpy(_np32(v)) for k, v in out.items()}


def pixel_projector_tree_from_state_dict(sd: dict) -> dict:
    """Inverse of :func:`pixel_projector_state_dict_from_flax`: the JAX
    tree of fp32 numpy arrays (what ``train-adapter`` pickles)."""
    return {name: _dense_ln_to_flax(sd, name, norm=name.startswith("ln"))
            for name in _PROJECTOR}


def convert_pixel_projector(sd: dict) -> dict[str, torch.Tensor]:
    """The reference's ``PixelProjector_best.bin`` (a torch ``Sequential``:
    1 = Linear(1, 257), 2 = LayerNorm(257), 4 = Linear(1024, 1024),
    5 = LayerNorm(1024); 0 and 3 are parameter-free rearranges) → the
    port's ``state_dict`` (fp32; load strictly)."""
    names = {"1": "expand", "2": "ln_tokens", "4": "proj", "5": "ln"}
    out = {}
    for k, v in sd.items():
        idx, leaf = k.split(".", 1)
        if idx not in names:
            raise ValueError(f"{k}: not a key of the reference "
                             "PixelProjector (Sequential indices 1, 2, 4, 5)")
        out[f"{names[idx]}.{leaf}"] = torch.from_numpy(_np32(v))
    return out


# ——— the metric backbones (eval/backbones.py) ———

_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}


def _swav_flax_name(name: str) -> str:
    """``layer2.0.conv3`` → ``layer2_0/c/conv``, ``layer2.0.downsample.1``
    → ``layer2_0/down/bn``; ``conv1`` and ``bn1`` keep their names."""
    parts = name.split(".")
    if len(parts) == 1:
        return name
    layer, block, unit, *rest = parts
    if unit == "downsample":
        return f"{layer}_{block}/down/" + ("conv" if rest[0] == "0" else "bn")
    return f"{layer}_{block}/{'abc'[int(unit[-1]) - 1]}/{unit[:-1]}"


def _effnet_flax_name(name: str) -> str:
    """``features.0.0`` → ``stem_conv``, ``features.8.1`` → ``head_bn``,
    ``features.2.1.block.{u}.{0,1}`` → ``stage2_1/{expand,dw,project}_{conv,
    bn}``, ``features.2.1.block.{u}.fc1`` → ``stage2_1/se_fc1``."""
    from eeg_image_decode_tpu_torch.eval.backbones import _EFFNET_B1_STAGES

    p = name.split(".")
    if p[1] in ("0", "8"):
        return ("stem" if p[1] == "0" else "head") + (
            "_conv" if p[2] == "0" else "_bn")
    stage = int(p[1])
    units = ("expand", "dw", "se", "project")
    if _EFFNET_B1_STAGES[stage - 1][0] == 1:
        units = units[1:]
    unit, leaf = units[int(p[4])], p[5]
    if unit == "se":
        return f"stage{stage}_{p[2]}/se_{leaf}"
    return f"stage{stage}_{p[2]}/{unit}_" + ("conv" if leaf == "0" else "bn")


#: ``--backbone-params`` key → the port module name → the flax module path
_BACKBONE_FLAX_NAMES = {
    "alexnet": lambda name: f"conv{name.split('.')[1]}",
    "swav": _swav_flax_name,
    "inception": lambda name: name.replace(".", "/"),
    "effnet": _effnet_flax_name,
}


def _backbone_key_map(kind: str) -> dict[str, tuple[str, bool]]:
    """The port backbone's ``state_dict`` keys (``num_batches_tracked``
    left out) → (the flax leaf path, whether it is a conv kernel)."""
    from eeg_image_decode_tpu_torch.eval.backbones import (
        BACKBONES,
        FrozenBatchNorm2d,
    )

    if kind not in BACKBONES:
        raise ValueError(f"backbone kind must be one of {sorted(BACKBONES)},"
                         f" not {kind!r}")
    with torch.device("meta"):
        model = BACKBONES[kind]()
    rename = _BACKBONE_FLAX_NAMES[kind]
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            for leaf, flax_leaf in _BN_LEAVES.items():
                out[f"{name}.{leaf}"] = (f"{rename(name)}/{flax_leaf}", False)
        elif isinstance(m, torch.nn.Conv2d):
            out[f"{name}.weight"] = (f"{rename(name)}/kernel", True)
            if m.bias is not None:
                out[f"{name}.bias"] = (f"{rename(name)}/bias", False)
    return out


def _same_keys(what: str, got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:5]} ({len(missing)}), "
                       f"unexpected {extra[:5]} ({len(extra)})")


def backbone_state_dict_from_flax(kind: str, tree: dict
                                  ) -> dict[str, torch.Tensor]:
    """A JAX metric backbone's param tree (``kind``: ``alexnet``,
    ``inception``, ``effnet`` or ``swav``, the ``--backbone-params``
    pickle's keys) → the port module's ``state_dict`` (fp32; load it with
    ``strict=True``). Conv kernels HWIO → OIHW (the depthwise kernel's
    I = 1 included); ``FrozenBN`` ``scale``/``bias``/``mean``/``var`` →
    ``weight``/``bias``/``running_mean``/``running_var``. A missing or
    extra leaf raises and names it."""
    flat = _flatten(tree)
    keys = _backbone_key_map(kind)
    _same_keys(f"{kind} flax tree", flat, [p for p, _ in keys.values()])
    out = {}
    for key, (path, conv) in keys.items():
        a = np.asarray(flat[path], np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(a, (3, 2, 0, 1)) if conv else a))
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = (
                torch.tensor(0))
    return out


def backbone_tree_from_state_dict(kind: str, sd: dict) -> dict:
    """Inverse of :func:`backbone_state_dict_from_flax`: the port module's
    ``state_dict`` (``num_batches_tracked`` ignored) → the JAX param tree
    as fp32 numpy (the layout the JAX ``convert_*`` functions write)."""
    keys = _backbone_key_map(kind)
    _same_keys(f"{kind} state_dict",
               [k for k in sd if not k.endswith(".num_batches_tracked")],
               keys)
    tree: dict = {}
    for key, (path, conv) in keys.items():
        a = _np32(sd[key])
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(
            np.transpose(a, (2, 3, 1, 0)) if conv else a)
    return tree
