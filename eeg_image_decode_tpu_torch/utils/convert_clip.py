"""CLIP tower weights into the port (counterpart of
``eeg_image_decode_tpu/utils/convert_clip.py``).

The port's towers (``models/clip_vit.py``) use OpenCLIP's parameter names
and layouts, so two sources load into them:

- an OpenCLIP ``state_dict`` (the published ViT-H/14 weights): the vision
  tower takes the ``visual.*`` keys with the prefix stripped, the text tower
  the rest; only ``logit_scale`` is left over (:func:`openclip_state_dicts`);
- the JAX package's flax trees (``convert_openclip_vision`` /
  ``convert_openclip_text`` output, the ``--clip-params`` pickle of ``cli
  features``), through the inverse of those converters
  (:func:`clip_state_dict_from_flax`): the q/k/v kernels (W, heads,
  head_dim) pack into ``in_proj_weight`` (3W, W), ``out`` (heads,
  head_dim, W) becomes ``out_proj`` (W, W), dense kernels (in, out) become
  torch (out, in) weights and the HWIO patch conv (P, P, 3, W) the
  (W, 3, P, P) ``conv1``.

:func:`clip_tree_from_state_dict` is the way back, with which a smoke run
or a test writes a ``--clip-params`` pickle from the port's towers.
:func:`convert_hf_clip_vision` takes a transformers ``CLIPVisionModel``
dict, or GIT's vision tower (``git.image_encoder.*`` with that prefix
stripped), into the vision tower: the grid tower of ``train-adapter``.
"""

from __future__ import annotations

import numpy as np
import torch

from eeg_image_decode_tpu_torch.utils.convert import load_numpy_pickle


def _ln_from_flax(out: dict, prefix: str, leaf: dict) -> None:
    out[f"{prefix}.weight"] = leaf["scale"]
    out[f"{prefix}.bias"] = leaf["bias"]


def _block_from_flax(out: dict, prefix: str, blk: dict) -> None:
    _ln_from_flax(out, f"{prefix}.ln_1", blk["ln_1"])
    _ln_from_flax(out, f"{prefix}.ln_2", blk["ln_2"])
    attn = blk["attn"]
    width = np.shape(attn["query"]["kernel"])[0]
    # flax kernel (W_in, heads, head_dim) → torch rows (W_out, W_in)
    out[f"{prefix}.attn.in_proj_weight"] = np.concatenate(
        [np.asarray(attn[n]["kernel"]).reshape(width, width).T
         for n in ("query", "key", "value")])
    out[f"{prefix}.attn.in_proj_bias"] = np.concatenate(
        [np.asarray(attn[n]["bias"]).reshape(-1)
         for n in ("query", "key", "value")])
    out[f"{prefix}.attn.out_proj.weight"] = np.asarray(
        attn["out"]["kernel"]).reshape(width, width).T
    out[f"{prefix}.attn.out_proj.bias"] = attn["out"]["bias"]
    for name, torch_name in (("mlp_fc", "c_fc"), ("mlp_proj", "c_proj")):
        out[f"{prefix}.mlp.{torch_name}.weight"] = np.asarray(
            blk[name]["kernel"]).T
        out[f"{prefix}.mlp.{torch_name}.bias"] = blk[name]["bias"]


def _blocks(tree: dict) -> int:
    n = 0
    while f"block_{n}" in tree:
        n += 1
    return n


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    """Values (numpy arrays or torch tensors) → fp32 tensors."""
    return {k: (v.detach().float() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, dtype=np.float32)))
            for k, v in sd.items()}


def clip_state_dict_from_flax(tree: dict, kind: str) -> dict[str, torch.Tensor]:
    """A JAX tower's param tree (nested dicts of numpy arrays) → the port
    tower's ``state_dict`` (fp32); ``kind`` is ``"vision"`` or ``"text"``.
    Load it with ``load_state_dict(sd, strict=True)``."""
    out: dict = {}
    if kind == "vision":
        out["conv1.weight"] = np.transpose(
            np.asarray(tree["patch_embed"]["kernel"]), (3, 2, 0, 1))
        out["class_embedding"] = tree["class_embedding"]
        out["positional_embedding"] = tree["positional_embedding"]
        _ln_from_flax(out, "ln_pre", tree["ln_pre"])
        _ln_from_flax(out, "ln_post", tree["ln_post"])
        out["proj"] = tree["proj"]
    elif kind == "text":
        out["token_embedding.weight"] = tree["token_embedding"]["embedding"]
        out["positional_embedding"] = tree["positional_embedding"]
        _ln_from_flax(out, "ln_final", tree["ln_final"])
        out["text_projection"] = tree["text_projection"]
    else:
        raise ValueError(f"kind must be 'vision' or 'text', not {kind!r}")
    for i in range(_blocks(tree)):
        _block_from_flax(out, f"transformer.resblocks.{i}", tree[f"block_{i}"])
    return _tensors(out)


def clip_tree_from_state_dict(sd: dict, kind: str, heads: int) -> dict:
    """Inverse of :func:`clip_state_dict_from_flax`: a port tower's
    ``state_dict`` → the JAX tower's param tree as fp32 numpy (the layout
    ``convert_openclip_vision`` / ``convert_openclip_text`` write)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}

    def ln(p):
        return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}

    if kind == "vision":
        tree = {"patch_embed": {"kernel": np.ascontiguousarray(
                    np.transpose(sd["conv1.weight"], (2, 3, 1, 0)))},
                "class_embedding": sd["class_embedding"],
                "positional_embedding": sd["positional_embedding"],
                "ln_pre": ln("ln_pre"), "ln_post": ln("ln_post"),
                "proj": sd["proj"]}
    elif kind == "text":
        tree = {"token_embedding": {"embedding": sd["token_embedding.weight"]},
                "positional_embedding": sd["positional_embedding"],
                "ln_final": ln("ln_final"),
                "text_projection": sd["text_projection"]}
    else:
        raise ValueError(f"kind must be 'vision' or 'text', not {kind!r}")
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}"
        w_in = sd[f"{p}.attn.in_proj_weight"]
        width = w_in.shape[1]
        hd = width // heads
        wq, wk, wv = np.split(w_in, 3)
        bq, bk, bv = np.split(sd[f"{p}.attn.in_proj_bias"], 3)

        def fold(w, b):
            return {"kernel": np.ascontiguousarray(
                        w.T.reshape(width, heads, hd)),
                    "bias": b.reshape(heads, hd)}

        tree[f"block_{i}"] = {
            "ln_1": ln(f"{p}.ln_1"), "ln_2": ln(f"{p}.ln_2"),
            "attn": {"query": fold(wq, bq), "key": fold(wk, bk),
                     "value": fold(wv, bv),
                     "out": {"kernel": np.ascontiguousarray(
                                 sd[f"{p}.attn.out_proj.weight"].T.reshape(
                                     heads, hd, width)),
                             "bias": sd[f"{p}.attn.out_proj.bias"]}},
            "mlp_fc": {"kernel": np.ascontiguousarray(
                           sd[f"{p}.mlp.c_fc.weight"].T),
                       "bias": sd[f"{p}.mlp.c_fc.bias"]},
            "mlp_proj": {"kernel": np.ascontiguousarray(
                             sd[f"{p}.mlp.c_proj.weight"].T),
                         "bias": sd[f"{p}.mlp.c_proj.bias"]},
        }
        i += 1
    return tree


def openclip_state_dicts(sd: dict) -> tuple[dict, dict]:
    """An OpenCLIP model's ``state_dict`` (numpy arrays or tensors) →
    (vision, text) ``state_dict`` of the port's towers (fp32).
    ``logit_scale`` is the one key neither tower takes."""
    vision, text = {}, {}
    for k, v in sd.items():
        if k == "logit_scale":
            continue
        if k.startswith("visual."):
            vision[k[len("visual."):]] = v
        else:
            text[k] = v
    return _tensors(vision), _tensors(text)


def convert_hf_clip_vision(sd: dict, cfg) -> dict[str, torch.Tensor]:
    """A transformers ``CLIPVisionModel(WithProjection)`` state dict, or
    GIT's ``git.image_encoder`` one with that prefix stripped → the port
    vision tower's ``state_dict`` (fp32) for ``cfg`` (a
    ``CLIPVisionConfig``; ``cfg.layers`` blocks are read). q, k and v
    stack into ``in_proj``; transformers keeps CLIP's ``pre_layrnorm``
    typo. ``visual_projection.weight`` exists only on the WithProjection
    variant; grid consumers never use ``proj``, so an identity fills in
    when it is absent (width must equal embed_dim)."""
    sd = _tensors(sd)
    v = "vision_model"
    out = {
        "conv1.weight": sd[f"{v}.embeddings.patch_embedding.weight"],
        "class_embedding": sd[f"{v}.embeddings.class_embedding"].reshape(-1),
        "positional_embedding": sd[f"{v}.embeddings.position_embedding.weight"],
    }
    if "visual_projection.weight" in sd:
        out["proj"] = sd["visual_projection.weight"].T.contiguous()
    elif cfg.width == cfg.embed_dim:
        out["proj"] = torch.eye(cfg.width)
    else:
        raise ValueError("a projection-free checkpoint needs width == "
                         f"embed_dim (grid consumers never use proj); got "
                         f"{cfg.width} and {cfg.embed_dim}")
    renames = [("ln_pre", f"{v}.pre_layrnorm"),
               ("ln_post", f"{v}.post_layernorm")]
    for i in range(cfg.layers):
        hf, p = f"{v}.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for leaf in ("weight", "bias"):
            out[f"{p}.attn.in_proj_{leaf}"] = torch.cat(
                [sd[f"{hf}.self_attn.{n}_proj.{leaf}"] for n in "qkv"])
        renames += [(f"{p}.attn.out_proj", f"{hf}.self_attn.out_proj"),
                    (f"{p}.ln_1", f"{hf}.layer_norm1"),
                    (f"{p}.ln_2", f"{hf}.layer_norm2"),
                    (f"{p}.mlp.c_fc", f"{hf}.mlp.fc1"),
                    (f"{p}.mlp.c_proj", f"{hf}.mlp.fc2")]
    for port, hf in renames:
        out[f"{port}.weight"] = sd[f"{hf}.weight"]
        out[f"{port}.bias"] = sd[f"{hf}.bias"]
    return out


def load_clip_params(path: str) -> dict:
    """The ``--clip-params`` pickle (``{'vision': tree, 'text': tree}`` of
    numpy arrays, as ``convert_openclip_vision`` / ``_text`` write it),
    read without importing JAX."""
    return load_numpy_pickle(path)
