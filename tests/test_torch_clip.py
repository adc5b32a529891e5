"""The port's CLIP feature path against the JAX package, in fp32 on the
CPU: the BPE tokenizer (ids bit-equal), the tiny vision and text towers
(both activations, ``return_grid``, ``return_states``; max abs diff ≤
1e-5), one full-width ViT-H block (relative L2 ≤ 1e-5), the two weight
loaders (the JAX trees and an OpenCLIP ``state_dict``, tensor for tensor),
and the ``--clip-params`` reader."""

import importlib.util
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.data.tokenizers import (
    CLIPBPETokenizer as JaxTokenizer,
)
from eeg_image_decode_tpu.models import clip_vit as jclip
from eeg_image_decode_tpu.utils.convert_clip import (
    convert_openclip_text,
    convert_openclip_vision,
)
from eeg_image_decode_tpu_torch.data import tokenizers as ptok
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_clip_vocab,
)
from eeg_image_decode_tpu_torch.models import clip_vit as pclip
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    _block_from_flax,
    clip_state_dict_from_flax,
    clip_tree_from_state_dict,
    load_clip_params,
    openclip_state_dicts,
)
from test_tokenizers import CLIP_BATTERY, _write_clip_vocab
from torch_port_case import two_threads  # noqa: F401 (autouse)

PROMPTS = [f"This picture is {c}" for c in (
    "aardvark", "abacus", "ice_cream", "t-shirt", "baby's bottle",
    "air conditioner", "ball2")]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(tower, *shape, dtype=jnp.float32, seed=0):
    return _numpy(tower.init(jax.random.key(seed),
                             jnp.zeros(shape, dtype))["params"])


def test_tokenizer_ids_bit_equal_on_the_battery(tmp_path):
    vocab, merges = _write_clip_vocab(tmp_path)
    want = JaxTokenizer.from_files(vocab, merges)(CLIP_BATTERY)
    got = ptok.CLIPBPETokenizer.from_files(vocab, merges)(CLIP_BATTERY)
    assert got.dtype == np.int32 and got.shape == (len(CLIP_BATTERY), 77)
    np.testing.assert_array_equal(got, want)


def test_synthetic_full_size_vocab_pools_at_eot(tmp_path):
    """The 49,408-id stand-in vocabulary: both packages' tokenizers give
    the same ids, every piece of a prompt is in the vocabulary (none maps
    to ``<|endoftext|>``), and the row's largest id is ``<|endoftext|>``
    (49,407) at the end of the prompt, where the text tower pools; ``re``
    in place of ``regex`` (the card host may lack it) gives the same
    ids."""
    vocab, merges = write_synthetic_clip_vocab(str(tmp_path), PROMPTS)
    port = ptok.CLIPBPETokenizer.from_files(vocab, merges)
    got = port(PROMPTS)
    np.testing.assert_array_equal(
        got, JaxTokenizer.from_files(vocab, merges)(PROMPTS))
    assert len(port.encoder) == 49408
    assert (port.bos_id, port.eos_id) == (49406, 49407)
    assert (got[:, 0] == 49406).all()
    n_ids = [len(port.encode(p)) for p in PROMPTS]
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(n_ids) - 1)
    for row, n in zip(got, n_ids):
        assert (row[1:n - 1] < 49406).all() and (row[n - 1:] == 49407).all()

    spec = importlib.util.spec_from_file_location("_tok_re", ptok.__file__)
    no_regex = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("regex")
    sys.modules["regex"] = None  # import regex → ImportError
    try:
        spec.loader.exec_module(no_regex)
    finally:
        if saved is None:
            del sys.modules["regex"]
        else:
            sys.modules["regex"] = saved
    assert no_regex._CLIP_PAT.pattern != ptok._CLIP_PAT.pattern
    np.testing.assert_array_equal(
        no_regex.CLIPBPETokenizer.from_files(vocab, merges)(PROMPTS), got)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_tiny_towers_match_jax(act):
    vcfg, tcfg = jclip.CLIPVisionConfig.tiny(act), jclip.CLIPTextConfig.tiny(act)
    jv, jt = jclip.CLIPVisionTower(vcfg), jclip.CLIPTextTower(tcfg)
    vp = _jax_params(jv, 1, 32, 32, 3)
    tp = _jax_params(jt, 1, 12, dtype=jnp.int32, seed=1)
    pv = pclip.CLIPVisionTower(pclip.CLIPVisionConfig.tiny(act))
    pt = pclip.CLIPTextTower(pclip.CLIPTextConfig.tiny(act))
    pv.load_state_dict(clip_state_dict_from_flax(vp, "vision"), strict=True)
    pt.load_state_dict(clip_state_dict_from_flax(tp, "text"), strict=True)

    rng = np.random.default_rng(3)
    raw = rng.random((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 12)).astype(np.int32)
    ids[np.arange(3), [4, 7, 11]] = 63  # EOT: the row's largest id
    ids[0, 5:] = 0

    j_img = np.asarray(jclip.clip_preprocess(jnp.asarray(raw)))
    p_img = pclip.clip_preprocess(torch.from_numpy(raw))
    np.testing.assert_allclose(p_img.numpy(), j_img, rtol=0, atol=1e-6)

    @jax.jit
    def jax_side(vp, tp, img, ids):
        return (jv.apply({"params": vp}, img),
                jv.apply({"params": vp}, img, return_grid=True),
                jt.apply({"params": tp}, ids, return_states=True))

    feats, grid, states = jax_side(vp, tp, j_img, ids)
    with torch.no_grad():
        got = {"feats": pv(p_img), "grid": pv(p_img, return_grid=True),
               **pt(torch.from_numpy(ids), return_states=True)}
        pooled = pt(torch.from_numpy(ids))
    want = {"feats": feats, "grid": grid, **states}
    assert got["grid"].shape == (3, 17, 64) and got["feats"].shape == (3, 32)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32, k
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(pooled.numpy(), got["pooled"].numpy())


def test_full_width_block_matches_jax():
    """One ViT-H/14 vision block at its published width (1280, 16 heads of
    80, 257 tokens, B 1), in fp32: relative L2 ≤ 1e-5."""
    width, heads, tokens = 1280, 16, 257
    jb = jclip._ResidualAttnBlock(width, heads, act="gelu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, tokens, width)).astype(np.float32)
    params = _numpy(jax.jit(jb.init)(jax.random.key(2), x)["params"])
    # non-trivial LayerNorms and biases
    for ln in ("ln_1", "ln_2"):
        params[ln]["scale"] = (1 + 0.1 * rng.normal(size=width)).astype(
            np.float32)
        params[ln]["bias"] = (0.1 * rng.normal(size=width)).astype(np.float32)
    for name in ("query", "key", "value"):
        params["attn"][name]["bias"] = (0.1 * rng.normal(
            size=(heads, width // heads))).astype(np.float32)
    want = np.asarray(jax.jit(jb.apply)({"params": params}, x))

    pb = pclip._ResidualAttnBlock(width, heads, act="gelu")
    sd: dict = {}
    _block_from_flax(sd, "block", params)
    pb.load_state_dict({k[len("block."):]: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pb(torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def _openclip_sd(rng, vcfg, tcfg):
    """A random OpenCLIP-layout ``state_dict`` (numpy) of the given towers:
    the port's own keys with the ``visual.`` prefix, plus ``logit_scale``."""
    v = pclip.CLIPVisionTower(vcfg).state_dict()
    t = pclip.CLIPTextTower(tcfg).state_dict()
    sd = {"logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}
    for prefix, part in (("visual.", v), ("", t)):
        for k, a in part.items():
            sd[prefix + k] = rng.normal(size=tuple(a.shape)).astype(np.float32)
    return sd


def test_openclip_loader_matches_jax_converter():
    """``openclip_state_dicts`` against the JAX ``convert_openclip_*``
    followed by ``clip_state_dict_from_flax``: the same tensors, key for
    key; only ``logit_scale`` is left over; both load strictly."""
    vcfg, tcfg = pclip.CLIPVisionConfig.tiny(), pclip.CLIPTextConfig.tiny()
    sd = _openclip_sd(np.random.default_rng(7), vcfg, tcfg)
    vision, text = openclip_state_dicts(sd)
    via_jax = {
        "vision": clip_state_dict_from_flax(
            convert_openclip_vision(sd, jclip.CLIPVisionConfig.tiny()),
            "vision"),
        "text": clip_state_dict_from_flax(
            convert_openclip_text(sd, jclip.CLIPTextConfig.tiny()), "text"),
    }
    for name, got in (("vision", vision), ("text", text)):
        want = via_jax[name]
        assert set(got) == set(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    n_used = sum(v.numel() for v in vision.values()) + sum(
        v.numel() for v in text.values())
    assert n_used == sum(np.size(a) for a in sd.values()) - 1
    pclip.CLIPVisionTower(vcfg).load_state_dict(vision, strict=True)
    pclip.CLIPTextTower(tcfg).load_state_dict(text, strict=True)


@pytest.mark.parametrize("kind", ["vision", "text"])
def test_tree_round_trip(kind):
    """``clip_tree_from_state_dict`` inverts ``clip_state_dict_from_flax``
    on the JAX tower's own tree (its keys, shapes and values)."""
    if kind == "vision":
        tree = _jax_params(jclip.CLIPVisionTower(jclip.CLIPVisionConfig.tiny()),
                           1, 32, 32, 3)
    else:
        tree = _jax_params(jclip.CLIPTextTower(jclip.CLIPTextConfig.tiny()),
                           1, 12, dtype=jnp.int32)
    back = clip_tree_from_state_dict(clip_state_dict_from_flax(tree, kind),
                                     kind, heads=2)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))


def test_clip_params_reader_refuses_jax_leaves(tmp_path):
    """The ``--clip-params`` reader takes numpy trees and refuses a pickle
    of ``jax.Array`` leaves before importing anything of JAX."""
    tree = {"vision": {"proj": np.ones((2, 3), np.float32)},
            "text": {"ln_final": {"scale": np.zeros(3, np.float32)}}}
    ok = tmp_path / "ok.pkl"
    ok.write_bytes(pickle.dumps(tree))
    got = load_clip_params(str(ok))
    np.testing.assert_array_equal(got["vision"]["proj"], tree["vision"]["proj"])
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"vision": {"proj": jnp.ones((2, 3))}}))
    with pytest.raises(pickle.UnpicklingError, match="jax.Array"):
        load_clip_params(str(bad))
