"""The port's captioning modules against the JAX package, fp32 on the CPU at
``GITConfig.tiny()`` widths.

- ``PixelProjector``: fp32 ≤ 1e-5, bf16 ≤ 2⁻⁶ (the products rounded to bf16
  on both sides, two bf16 ulps at the output's scale); the reference
  ``Sequential`` converter bit-equal to JAX's;
- ``GITCaptioner``: logits ≤ 1e-5 of max|logit|; greedy ids equal to JAX's
  ``generate``, with rows that emit EOS at the first step and are padded;
- the converters: the transformers-named dict loads strictly, the JAX
  pickle round-trips bit for bit, the config derivations agree, a
  truncating config and non-contiguous layers are refused;
  ``convert_hf_clip_vision`` bit-equal to JAX's;
- ``WordPieceTokenizer``: ids and decodes equal to JAX's;
- ``train_pixel_projector``: per-epoch losses against JAX's on the same
  permutations and init, 3 epochs (fp32: ≤ 1e-5 relative in the first
  epoch, ≤ 1e-4 after, where Adam's normalised steps amplify
  rounding-level differences).

JAX weights: shapes from ``jax.eval_shape``, leaves drawn from a numpy seed;
the JAX side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.data import tokenizers as jtok
from eeg_image_decode_tpu.models import git_caption as jgit
from eeg_image_decode_tpu.train import adapters as jadapters
from eeg_image_decode_tpu.utils import convert_clip as jclip
from eeg_image_decode_tpu_torch.data import tokenizers as ptok
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_wordpiece_vocab,
)
from eeg_image_decode_tpu_torch.models import git_caption as pgit
from eeg_image_decode_tpu_torch.models.clip_vit import CLIPVisionConfig
from eeg_image_decode_tpu_torch.train import adapters as padapters
from eeg_image_decode_tpu_torch.utils import convert as pconvert
from eeg_image_decode_tpu_torch.utils import convert_clip as pclip
from eeg_image_decode_tpu_torch.utils.convert import load_numpy_pickle
from torch_port_case import randomize

CFG = jgit.GITConfig.tiny()
#: GIT logits against JAX, relative to max|logit| (fp32 on both sides)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _git_tree(cfg=CFG, seed=0):
    model = jgit.GITCaptioner(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0),
        jnp.zeros((1, cfg.num_visual_tokens, cfg.visual_dim)),
        jnp.zeros((1, 2), jnp.int32))["params"]
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), seed)


def _port_git(tree, cfg):
    pcfg = pgit.GITConfig(**{f: getattr(cfg, f) for f in
                             cfg.__dataclass_fields__})
    return pgit.GITCaptioner(pcfg).load_params(tree).eval()


def _equal_trees(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(la, lb):
        assert np.shape(x) == np.shape(y), path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


# ——— PixelProjector ———

#: bf16 products on both sides: the outputs of the final fp32 LayerNorm
#: (scale ≈ 1) agree to two bf16 ulps at their magnitude
BF16_TOL = 2.0 ** -6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_projector_matches_jax(dtype):
    rng = np.random.default_rng(1)
    T, D, O = 5, 16, 12
    proj = jgit.PixelProjector(num_tokens=T, out_dim=O,
                               dtype=getattr(jnp, dtype))
    tree = randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(proj.init, jax.random.key(0),
                       jnp.zeros((1, D)))["params"]), 2)
    x = (rng.normal(size=(4, D)) / np.sqrt(D)).astype(np.float32)
    want = np.asarray(jax.jit(proj.apply)({"params": tree}, x))
    port = pgit.PixelProjector(T, D, O, dtype=getattr(torch, dtype))
    port.load_state_dict(pconvert.pixel_projector_state_dict_from_flax(tree),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    _equal_trees(pconvert.pixel_projector_tree_from_state_dict(
        port.state_dict()), tree)


def test_pixel_projector_converts_from_reference_layout():
    """The reference ``Sequential`` (indices 1, 2, 4, 5) through the port's
    converter equals the JAX converter's tree, bit for bit."""
    rng = np.random.default_rng(3)
    T, D = 5, 16
    sd = {"1.weight": rng.normal(size=(T, 1)), "1.bias": rng.normal(size=T),
          "2.weight": rng.normal(size=T), "2.bias": rng.normal(size=T),
          "4.weight": rng.normal(size=(D, D)), "4.bias": rng.normal(size=D),
          "5.weight": rng.normal(size=D), "5.bias": rng.normal(size=D)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    port = pconvert.convert_pixel_projector(sd)
    _equal_trees(pconvert.pixel_projector_tree_from_state_dict(port),
                 jgit.convert_pixel_projector(sd))
    pgit.PixelProjector(T, D, D).load_state_dict(port, strict=True)
    with pytest.raises(ValueError, match="Sequential indices"):
        pconvert.convert_pixel_projector({**sd, "3.weight": sd["1.bias"]})


# ——— the decoder ———


@pytest.fixture(scope="module")
def git_pair():
    tree = _git_tree()
    return tree, _port_git(tree, CFG)


def test_git_logits_match_jax(git_pair):
    tree, port = git_pair
    rng = np.random.default_rng(4)
    vis = rng.normal(size=(3, CFG.num_visual_tokens, CFG.visual_dim)
                     ).astype(np.float32)
    ids = rng.integers(0, CFG.vocab_size, size=(3, 6)).astype(np.int32)
    want = np.asarray(jax.jit(jgit.GITCaptioner(CFG).apply)(
        {"params": tree}, vis, ids))
    with torch.no_grad():
        got = port(torch.from_numpy(vis), torch.from_numpy(ids).long())
    assert got.shape == (3, 6, CFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_greedy_ids_match_jax_with_early_eos(git_pair):
    """The lm head's EOS bias is raised to the median first-step gap, so
    about half the rows emit EOS at once and are padded after it."""
    tree = jax.tree_util.tree_map(np.copy, git_pair[0])
    rng = np.random.default_rng(5)
    vis = rng.normal(size=(6, CFG.num_visual_tokens, CFG.visual_dim)
                     ).astype(np.float32)
    model = jgit.GITCaptioner(CFG)
    bos = np.full((6, 1), CFG.bos_token_id, np.int32)
    first = np.asarray(jax.jit(model.apply)({"params": tree}, vis, bos))[:, 0]
    others = np.delete(first, CFG.eos_token_id, axis=1).max(axis=1)
    gap = others - first[:, CFG.eos_token_id]
    tree["lm_head"]["bias"][CFG.eos_token_id] += np.float32(np.median(gap))
    want = np.asarray(model.generate({"params": tree}, jnp.asarray(vis),
                                     max_new_tokens=6))
    got = _port_git(tree, CFG).generate(torch.from_numpy(vis),
                                        max_new_tokens=6).numpy()
    assert got.shape == want.shape == (6, 7)
    np.testing.assert_array_equal(got, want)
    early = got[:, 1] == CFG.eos_token_id
    assert 0 < early.sum() < 6
    assert (got[early, 2:] == CFG.pad_token_id).all()


def test_bf16_git_matches_jax(git_pair):
    """``GITCaptioner(dtype=bfloat16)`` against JAX's on the same tiny
    weights: the logits relative to max|logit| (both sides round the
    products, the residual sums and each softmax step to bf16 and run the
    LayerNorms and the lm head in fp32, but sum in other orders and take
    GELU and the softmax's exp through other fp32 paths, so an activation
    may sit one bf16 step apart: measured 7.1e-3 of max|logit|; 3e-2
    stated), and the greedy ids of the whole decode. A row may leave JAX's
    ids only at a near-tie: where the two tokens' logits in JAX's own
    forward of its prefix lie within that tolerance (measured: one row of
    six, at a gap of 8.9e-3 that JAX's jitted decode and its forward
    resolve differently); the rest of such a row follows another prefix."""
    tree = git_pair[0]
    rng = np.random.default_rng(6)
    vis = rng.normal(size=(6, CFG.num_visual_tokens, CFG.visual_dim)
                     ).astype(np.float32)
    ids = rng.integers(0, CFG.vocab_size, size=(6, 6)).astype(np.int32)
    jmodel = jgit.GITCaptioner(CFG, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jmodel.apply)({"params": tree}, vis, ids))
    pcfg = pgit.GITConfig(**{f: getattr(CFG, f) for f in
                             CFG.__dataclass_fields__})
    port = pgit.GITCaptioner(pcfg, dtype=torch.bfloat16).load_params(tree)
    with torch.no_grad():
        got = port(torch.from_numpy(vis), torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    tol = 3e-2 * np.abs(want).max()
    want_ids = np.asarray(jmodel.generate({"params": tree}, jnp.asarray(vis),
                                          max_new_tokens=6))
    got_ids = port.generate(torch.from_numpy(vis), max_new_tokens=6).numpy()
    assert got_ids.shape == want_ids.shape == (6, 7)
    equal_rows = 0
    for r in range(6):
        diff = np.nonzero(got_ids[r] != want_ids[r])[0]
        if not len(diff):
            equal_rows += 1
            continue
        i = diff[0]
        logits = np.asarray(jax.jit(jmodel.apply)(
            {"params": tree}, vis[r:r + 1], want_ids[r:r + 1, :i]))[0, -1]
        gap = abs(logits[want_ids[r, i]] - logits[got_ids[r, i]])
        assert gap <= tol, (r, i, gap, tol)
    assert equal_rows >= 5, equal_rows
    # the fp32 default is the module it was: the same logits as before
    with torch.no_grad():
        f32 = git_pair[1](torch.from_numpy(vis), torch.from_numpy(ids).long())
    assert git_pair[1].dtype == torch.float32
    assert float((f32 - got).abs().max()) > 0


def test_bf16_caption_embeddings_match_jax(git_pair):
    """``caption_embeddings`` runs the projector at the captioner's dtype,
    as JAX builds it (``PixelProjector(dtype=captioner.dtype)``): the same
    ids from an fp32-built projector as from JAX's bf16 one."""
    tree = git_pair[0]
    rng = np.random.default_rng(7)
    d = 24
    jproj = jgit.PixelProjector(num_tokens=CFG.num_visual_tokens,
                                out_dim=CFG.visual_dim)
    ptree = randomize(jax.tree_util.tree_map(
        lambda sh: np.zeros(sh.shape, np.float32),
        jax.eval_shape(jproj.init, jax.random.key(0),
                       jnp.zeros((1, d)))["params"]), 8)
    emb = (rng.normal(size=(5, d)) / np.sqrt(d)).astype(np.float32)

    class Ids:
        @staticmethod
        def decode(row):
            return " ".join(str(t) for t in row)

    want = jgit.caption_embeddings(
        jgit.GITCaptioner(CFG, dtype=jnp.bfloat16), {"params": tree}, ptree,
        jnp.asarray(emb), Ids(), max_new_tokens=5)
    pcfg = pgit.GITConfig(**{f: getattr(CFG, f) for f in
                             CFG.__dataclass_fields__})
    proj = pgit.PixelProjector(CFG.num_visual_tokens, d, CFG.visual_dim)
    proj.load_state_dict(pconvert.pixel_projector_state_dict_from_flax(ptree),
                         strict=True)
    git = pgit.GITCaptioner(pcfg, dtype=torch.bfloat16).load_params(tree)
    got = pgit.caption_embeddings(git, proj, emb, None, max_new_tokens=5)
    assert got == want and len(got) == 5


# ——— the converters ———


def _hf_vision(rng, width=16, layers=1, n_tokens=5, patch=16, proj=True):
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight": (width, 3, patch, patch),
          f"{v}.embeddings.class_embedding": (width,),
          f"{v}.embeddings.position_embedding.weight": (n_tokens, width)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{v}.{ln}.weight"] = sd[f"{v}.{ln}.bias"] = (width,)
    for i in range(layers):
        p = f"{v}.encoder.layers.{i}"
        for name, (o, n) in {"self_attn.q_proj": (width, width),
                             "self_attn.k_proj": (width, width),
                             "self_attn.v_proj": (width, width),
                             "self_attn.out_proj": (width, width),
                             "mlp.fc1": (4 * width, width),
                             "mlp.fc2": (width, 4 * width)}.items():
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = (o, n), (o,)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{ln}.weight"] = sd[f"{p}.{ln}.bias"] = (width,)
    if proj:
        sd["visual_projection.weight"] = (width, width)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def test_git_checkpoint_converters():
    """The transformers-named dict (with GIT's vision tower) loads strictly
    into the port, and the JAX converter reads it back to the same tree;
    the JAX pickle round-trips; the config derivations agree; a truncating
    config and non-contiguous layers are refused."""
    cfg = jgit.GITConfig(vocab_size=64, d_model=128, n_layers=3, n_heads=2,
                         d_ff=96, max_position_embeddings=16, visual_dim=16)
    tree = _git_tree(cfg, seed=6)
    port_sd = pconvert.git_state_dict_from_flax(tree)
    vision = _hf_vision(np.random.default_rng(7))
    hf = {**{k: v.numpy() for k, v in port_sd.items()},
          **{f"git.image_encoder.{k}": v for k, v in vision.items()}}
    _equal_trees(jgit.convert_git_causal_lm(hf, cfg), tree)
    _equal_trees(pconvert.git_tree_from_state_dict(port_sd, cfg.n_heads),
                 tree)

    got_cfg, dec = pgit.convert_git_causal_lm(hf)
    want_cfg = jgit.git_config_from_state_dict(hf)
    assert dataclasses_equal(got_cfg, want_cfg)
    assert (got_cfg.d_model, got_cfg.n_layers, got_cfg.n_heads,
            got_cfg.d_ff) == (128, 3, 2, 96)
    model = pgit.GITCaptioner(got_cfg)
    model.load_state_dict(dec, strict=True)
    assert dataclasses_equal(pgit.git_config_from_params(tree),
                             jgit.git_config_from_params(tree))
    assert dataclasses_equal(
        pgit.git_config_from_params(tree, max_text_len=9),
        jgit.git_config_from_params(tree, max_text_len=9))

    small = pgit.GITConfig(vocab_size=64, d_model=128, n_layers=2,
                           n_heads=2, d_ff=96, max_position_embeddings=16,
                           visual_dim=16)
    with pytest.raises(ValueError, match="n_layers"):
        pgit.convert_git_causal_lm(hf, small)
    wide = pgit.GITConfig(vocab_size=64, d_model=192, n_layers=3, n_heads=3,
                          d_ff=96, max_position_embeddings=16, visual_dim=16)
    with pytest.raises(ValueError, match="d_model"):
        pgit.convert_git_causal_lm(hf, wide)
    gap = {k: v for k, v in hf.items()
           if not k.startswith("git.encoder.layer.1.")}
    with pytest.raises(ValueError, match="non-contiguous"):
        pgit.git_config_from_state_dict(gap)


def dataclasses_equal(a, b):
    return {f: getattr(a, f) for f in a.__dataclass_fields__} == {
        f: getattr(b, f) for f in b.__dataclass_fields__}


def test_git_pickle_round_trip(tmp_path, git_pair):
    import pickle

    tree, port = git_pair
    path = tmp_path / "git.pkl"
    with open(path, "wb") as f:
        pickle.dump(pconvert.git_tree_from_state_dict(port.state_dict(),
                                                      CFG.n_heads), f)
    back = load_numpy_pickle(str(path))
    _equal_trees(back, tree)
    again = _port_git(back, CFG)
    for k, v in port.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("proj", [True, False])
def test_hf_clip_vision_converter_matches_jax(proj):
    vision = _hf_vision(np.random.default_rng(8), proj=proj)
    jcfg = jclip.CLIPVisionConfig(image_size=32, patch_size=16, width=16,
                                  layers=1, heads=2, embed_dim=16,
                                  act="quick_gelu")
    want = pclip.clip_state_dict_from_flax(
        jclip.convert_hf_clip_vision(vision, jcfg), "vision")
    got = pclip.convert_hf_clip_vision(vision, CLIPVisionConfig(
        image_size=32, patch_size=16, width=16, layers=1, heads=2,
        embed_dim=16, act="quick_gelu"))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ——— WordPiece ———


def test_wordpiece_matches_jax(tmp_path):
    texts = ["A photo of a red aardvark, playing!",
             "Two WOODEN accordions on the Café table.", "naïve 東京 zebra"]
    path = write_synthetic_wordpiece_vocab(str(tmp_path), texts,
                                           vocab_size=300)
    port = ptok.WordPieceTokenizer.from_file(path)
    ref = jtok.WordPieceTokenizer.from_file(path)
    assert (port.cls_id, port.sep_id, port.pad_id) == (101, 102, 0)
    for t in [*texts, "accordionsx zebra", ""]:
        assert port.tokenize(t) == ref.tokenize(t)
        assert port.encode(t) == ref.encode(t)
        assert port.decode(port.encode(t)) == ref.decode(ref.encode(t))
    np.testing.assert_array_equal(port(texts, max_length=8),
                                  ref(texts, max_length=8))
    ids = np.random.default_rng(9).integers(0, 300, size=(5, 12))
    for row in ids:
        assert port.decode(row) == ref.decode(row)
    assert "##" not in port.decode(port.encode(texts[1]))


# ——— the adapter trainer ———

#: per-epoch loss against JAX, relative, fp32: the first epoch holds
#: 1e-5; after it Adam's normalised steps amplify rounding-level
#: differences in the gradients
ADAPTER_TOL = (1e-5, 1e-4, 1e-4)


def test_train_pixel_projector_matches_jax(monkeypatch):
    rng = np.random.default_rng(10)
    n, d, t, o = 40, 16, 5, 12
    x = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = rng.normal(size=(n, t, o)).astype(np.float32)
    cfg = jadapters.AdapterTrainConfig(epochs=3, batch_size=8, seed=3)
    init = jax.jit(jgit.PixelProjector(num_tokens=t, out_dim=o).init)(
        jax.random.key(cfg.seed), jnp.zeros((1, d)))["params"]
    init = jax.tree_util.tree_map(np.asarray, init)
    want_params, want = jadapters.train_pixel_projector(x, y, cfg,
                                                        dtype=jnp.float32)

    def jax_init(num_tokens, in_dim, out_dim, *, seed, dtype, device):
        assert (num_tokens, in_dim, out_dim, seed) == (t, d, o, cfg.seed)
        m = pgit.PixelProjector(num_tokens, in_dim, out_dim, dtype=dtype)
        m.load_state_dict(pconvert.pixel_projector_state_dict_from_flax(
            init), strict=True)
        return m

    monkeypatch.setattr(padapters, "init_pixel_projector", jax_init)
    proj, got = padapters.train_pixel_projector(
        x, y, padapters.AdapterTrainConfig(epochs=3, batch_size=8, seed=3),
        dtype=torch.float32, device="cpu")
    assert len(got) == 3
    for epoch, tol in enumerate(ADAPTER_TOL):
        np.testing.assert_allclose(got[epoch], want[epoch], rtol=tol)
    held = padapters.evaluate_pixel_projector(proj, x[:20], y[:20],
                                              batch_size=8)
    ref = jadapters.evaluate_pixel_projector(want_params, x[:20], y[:20],
                                             batch_size=8, dtype=jnp.float32)
    np.testing.assert_allclose(held, ref, rtol=1e-4)
    with pytest.raises(ValueError, match="need ≥8 samples"):
        padapters.train_pixel_projector(x[:5], y[:5], padapters.
                                        AdapterTrainConfig(batch_size=8),
                                        device="cpu")
