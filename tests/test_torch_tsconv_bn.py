"""The stage-1 BatchNorm modes of the port's tsconv stack against JAX's, on
the CPU.

- ``TSConv(fused_stage1=True, bn1_impl=m)`` for the four modes (``'flax'``,
  ``'gram'``, ``'gram2d'``, ``'gramfold'``), fp32 and bf16, at JAX's own
  test size (``tests/test_models.py::
  test_gram_stage1_bn_matches_flax_batchnorm``: x (8, 15, 64), 12 filters,
  9 taps, pool 16, stride 4, dropout 0): the train forward, the updated
  running statistics, the gradients of every parameter and of x, and the
  eval forward. On the CPU the port runs the kernels' plain versions, with
  the epilogue on the fp32 sums (``ops/tsconv.py``).
- A tiny ATM-S with ``fused_tsconv=True, tsconv_bn1='gram'``: one training
  step's loss and gradients, and a strict load of its JAX tree.
- Two gloo ranks: ``GramStage1BN``'s statistics under the mesh equal the
  one-process statistics of the global batch.
- The operand E, the epilogue's plain forward and backward, and the
  gating of the gram modes.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.losses.clip_loss import (
    retrieval_loss as jax_retrieval_loss,
)
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.models.layers import TSConv as JaxTSConv
from eeg_image_decode_tpu.ops.tsconv import (
    expand_folded_kernel as jax_expand_folded_kernel,
)
from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.losses.clip_loss import retrieval_loss
from eeg_image_decode_tpu_torch.models.layers import (
    BN1_IMPLS,
    GramStage1BN,
    TSConv,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.ops.tsconv import (
    apply_epilogue,
    expand_folded_kernel,
    tsconv_pool_fused,
    tsconv_pool_reference,
)
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from torch_port_case import SMALL, launch_ranks, randomize

#: JAX's test size (tests/test_models.py)
SHAPE = dict(filters=12, temporal_kernel=9, pool_size=16, pool_stride=4,
             emb_size=12, spatial_extent=15, dropout=0.0)
#: fp32: JAX's own tolerance for the gram modes against flax's BatchNorm
F32_TOL = dict(atol=2e-5, rtol=1e-4)
#: bf16: both sides round the product, the affine and each activation to
#: bf16 (8-bit mantissa) at the same points but sum in other orders, so an
#: output may land a bf16 step apart (1/64 at |y| in [2, 4); measured ≤
#: 2.4e-2 on outputs up to 3.5) and the running statistics differ by fp32
#: sums of such values (measured ≤ 2.6e-4). A gradient is held to its
#: largest entry: BN1's bias gradient sums 1,320 bf16 cotangents, which
#: JAX reduces in bf16 (measured 7.4e-2 of the largest entry in 'gram',
#: ≤ 1.9e-2 elsewhere), and by its cosine (measured ≥ 0.9986)
BF16_TOL = {"out": dict(atol=4e-2, rtol=1e-2),
            "stats": dict(atol=2e-3, rtol=1e-2),
            "grad": dict(atol=1.5e-1, rtol=0), "cosine": 0.995}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy()


def _jax_tsconv(impl, jdt, x, seed):
    """JAX's forward (train and eval), batch_stats update and gradients
    (params, x) of sum(out²), the gradient jitted; the variables as
    numpy."""
    m = JaxTSConv(**SHAPE, fused_stage1=True, bn1_impl=impl, dtype=jdt)
    xj = jnp.asarray(x)
    variables = randomize(m.init(jax.random.key(0), xj, deterministic=True),
                          seed)
    v = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss(params, a):
        out, upd = m.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, a,
                           deterministic=False, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.key(1)})
        out = out.astype(jnp.float32)
        return jnp.sum(out * out), (out, upd)

    (_, (out, upd)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], xj)
    out_eval = m.apply(v, xj, deterministic=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (variables, np.asarray(out), to_np(upd), to_np(grads[0]),
            np.asarray(grads[1]), np.asarray(out_eval.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", BN1_IMPLS)
def test_tsconv_bn1_modes_match_jax(impl, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(160)
    x = rng.normal(size=(8, 15, 64)).astype(np.float32)
    variables, out_j, upd_j, gp_j, gx_j, eval_j = _jax_tsconv(
        impl, jdt, x, seed=161)

    model = TSConv(**SHAPE, fused_stage1=True, bn1_impl=impl)
    model.load_state_dict(params_from_flax(variables, encoder="atms"),
                          strict=True)
    assert model.gram_mode(torch.from_numpy(x)) == (impl != "flax")
    with torch.no_grad():  # before the train step moves the statistics
        out_eval = model(torch.from_numpy(x), tdt, train=False)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, tdt, train=True).float()
    (out * out).sum().backward()

    tol = F32_TOL if dtype == "float32" else BF16_TOL["out"]
    np.testing.assert_allclose(_np(out), out_j, **tol)
    np.testing.assert_allclose(_np(out_eval), eval_j, **tol)
    stats = params_from_flax({"batch_stats": upd_j["batch_stats"]},
                             encoder="atms")
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) == {"bn1.mean", "bn1.var", "bn2.mean",
                                          "bn2.var"}
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == "float32"
           else BF16_TOL["stats"])
    for k, v in stats.items():
        np.testing.assert_allclose(_np(buffers[k]), v.numpy(), **tol,
                                   err_msg=k)
    want = params_from_flax({"params": gp_j}, encoder="atms")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) and len(got) == 8
    tol = F32_TOL if dtype == "float32" else BF16_TOL["grad"]
    for k, g in [*want.items(), ("x", torch.from_numpy(gx_j.copy()))]:
        g = g.numpy()
        a = _np(xt.grad if k == "x" else got[k])
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(a / scale, g / scale, **tol, err_msg=k)
        if dtype == "bfloat16":
            cos = (a * g).sum() / np.linalg.norm(a) / np.linalg.norm(g)
            assert cos >= BF16_TOL["cosine"], (k, cos)


def test_gram_modes_gate_as_jax():
    """A gram mode needs the fused path: ``True`` on any device, ``'auto'``
    for a CUDA input only, ``False`` never; NICE's and the default TSConv
    keep ``'flax'``; an unknown mode raises."""
    x = torch.zeros(2, 15, 64)
    kw = {k: v for k, v in SHAPE.items()}
    assert TSConv(**kw, fused_stage1=True, bn1_impl="gram").gram_mode(x)
    assert not TSConv(**kw, fused_stage1="auto",
                      bn1_impl="gram").gram_mode(x)
    assert not TSConv(**kw, fused_stage1=False,
                      bn1_impl="gram2d").gram_mode(x)
    assert TSConv(**kw).bn1_impl == "flax"
    assert ATMSConfig().tsconv_bn1 == JaxATMSConfig().tsconv_bn1 == "gram"
    atms = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu")
    assert atms.encoder.enc_eeg.bn1_impl == "gram"
    assert not atms.encoder.enc_eeg.gram_mode(torch.zeros(2, 8, 100))
    nice = build_encoder("nice", device="cpu")
    assert all(m.bn1_impl == "flax" for m in nice.modules()
               if isinstance(m, TSConv))
    with pytest.raises(ValueError, match="gramfold"):
        TSConv(**kw, bn1_impl="gram3d")


@pytest.mark.parametrize("stride", [4, 5])
def test_expand_folded_kernel_matches_jax(stride):
    """E and its gradient (a weighted sum) against JAX's, bit for bit in
    fp32: each entry of E is one tap or 0, and each tap's gradient is the
    sum of its P uses."""
    rng = np.random.default_rng(162)
    w = rng.normal(size=(24, 5)).astype(np.float32)
    probe = rng.normal(size=(64, ((64 - 24) // stride + 1) * 5)).astype(
        np.float32)
    gw = jax.grad(lambda a: jnp.sum(
        jax_expand_folded_kernel(a, 64, stride) * probe))(jnp.asarray(w))
    e_j = np.asarray(jax_expand_folded_kernel(jnp.asarray(w), 64, stride))
    wt = torch.from_numpy(w).requires_grad_(True)
    e = expand_folded_kernel(wt, 64, stride)
    assert e.shape == e_j.shape
    np.testing.assert_array_equal(e.detach().numpy(), e_j)
    (e * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-6,
                               atol=1e-6)
    x = torch.from_numpy(rng.normal(size=(3, 2, 64)).astype(np.float32))
    np.testing.assert_allclose(
        (x.reshape(6, 64) @ e.detach()).reshape(3, 2, -1, 5).numpy(),
        tsconv_pool_reference(x, wt.detach(), stride).numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", ["scale_shift_elu", "shift", "scale",
                                   "elu"])
def test_epilogue_plain_forward_and_backward(parts, dtype):
    """The plain epilogue: the fp32 sums, then the epilogue, rounded once
    (the no-epilogue forward is today's, bit for bit, and equals the
    epilogue-free output of the same sums rounded); its autograd Function's
    gradients against autograd of the plain expression in fp32."""
    rng = np.random.default_rng(163)
    x = torch.from_numpy(rng.normal(size=(4, 3, 40)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(11, 6)) / 3).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    sh = torch.from_numpy((0.2 * rng.normal(size=6)).astype(np.float32))
    kw = dict(scale=sc if "scale" in parts else None,
              shift=sh if "shift" in parts else None, elu="elu" in parts)
    xd = x.to(dtype)
    base = tsconv_pool_fused(xd, w, 3)
    assert torch.equal(base, tsconv_pool_reference(xd, w.to(dtype), 3))
    acc = torch.matmul(xd.float().reshape(12, 40).unfold(1, 11, 3),
                       w.to(dtype).float()).reshape(4, 3, -1, 6)
    want = apply_epilogue(acc, **kw).to(dtype)
    assert torch.equal(tsconv_pool_fused(xd, w, 3, **kw), want)

    leaves = [t.clone().requires_grad_(True) for t in (x, w, sc, sh)]
    probe = torch.from_numpy(rng.normal(size=tuple(acc.shape)).astype(
        np.float32))

    def grads(fn):
        for t in leaves:
            t.grad = None
        (fn(*leaves) * probe).sum().backward()
        return [t.grad for t in leaves]

    def fused(a, b, s, h):
        return tsconv_pool_fused(a, b, 3, scale=s if kw["scale"] is not None
                                 else None, shift=h if kw["shift"] is not None
                                 else None, elu=kw["elu"])

    def plain(a, b, s, h):
        y = torch.matmul(a.reshape(12, 40).unfold(1, 11, 3), b).reshape(
            4, 3, -1, 6)
        return apply_epilogue(y, s if kw["scale"] is not None else None,
                              h if kw["shift"] is not None else None,
                              kw["elu"])

    for g, r in zip(grads(fused), grads(plain)):
        if r is None:
            assert g is None or not g.any()
            continue
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_tiny_atms_gram_step_matches_jax():
    """``ATMSConfig(fused_tsconv=True, tsconv_bn1='gram')`` at SMALL width,
    dropout off: JAX's tree loads strictly (the tree is the flax mode's),
    and one training step's loss and every gradient match JAX's (the
    tolerances of ``tests/test_torch_train.py``'s first step)."""
    rng = np.random.default_rng(164)
    b, d = 8, SMALL["proj_dim"]
    cfg_kw = {**SMALL, "dropout": 0.0, "conv_dropout": 0.0,
              "proj_dropout": 0.0, "fused_tsconv": True,
              "tsconv_bn1": "gram"}
    eeg = (rng.normal(size=(b, SMALL["n_channels"], SMALL["seq_len"]))
           * 0.5).astype(np.float32)
    sids = np.full((b,), 1, np.int32)
    img, text = (rng.normal(size=(b, d)).astype(np.float32)
                 for _ in range(2))
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    text /= np.linalg.norm(text, axis=1, keepdims=True)

    jmodel = jax_build_encoder("atms", config=JaxATMSConfig(**cfg_kw))
    variables = randomize(jax.jit(lambda a, s: jmodel.init(
        jax.random.key(0), a, s, deterministic=True))(
        jnp.asarray(eeg[:2]), jnp.asarray(sids[:2])), 165)
    flax_tree = jax.eval_shape(lambda a, s: jax_build_encoder(
        "atms", config=JaxATMSConfig(**{**cfg_kw, "tsconv_bn1": "flax"}))
        .init(jax.random.key(0), a, s, deterministic=True),
        jnp.asarray(eeg[:2]), jnp.asarray(sids[:2]))
    assert (jax.tree_util.tree_structure(flax_tree)
            == jax.tree_util.tree_structure(variables))
    v = jax.tree_util.tree_map(jnp.asarray, variables)

    def jloss(params):
        (feats, scale), _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(eeg), jnp.asarray(sids), deterministic=False,
            mutable=["batch_stats"])
        return jax_retrieval_loss(feats.astype(jnp.float32),
                                  jnp.asarray(img), jnp.asarray(text), scale)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(v["params"])

    port_kw = {k: val for k, val in cfg_kw.items()
               if k in ATMSConfig.__dataclass_fields__}
    model = build_encoder("atms", config=ATMSConfig(**port_kw), device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    model.train()
    assert model.encoder.enc_eeg.gram_mode(torch.from_numpy(eeg))
    feats, scale = model(torch.from_numpy(eeg), torch.from_numpy(sids))
    loss = retrieval_loss(feats.float(), torch.from_numpy(img),
                          torch.from_numpy(text), scale)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    want = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                              grads_j)})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        gt = got[k] if got[k] is not None else torch.zeros_like(g)
        np.testing.assert_allclose(gt.numpy(), g.numpy(), atol=2e-4,
                                   rtol=1e-3, err_msg=k)


def test_gram_stats_over_two_ranks_match_the_global_batch():
    """Two gloo ranks, each with half the rows: ``GramStage1BN.affine``
    under the mesh gives the one-process (mul, add) and running statistics
    of the global batch, and the gradients of each rank's rows (dp times
    their global gradient, the dp convention) and of the taps."""
    rng = np.random.default_rng(166)
    x2 = torch.from_numpy(rng.normal(size=(16 * 5, 40)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(12, 6)) / 3).astype(np.float32))
    probe = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    bn = GramStage1BN(6)
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 6))
    xg = x2.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    e = expand_folded_kernel(wg, 40, 4)
    mul, add = bn.affine(xg, e, e.shape[1] // 6, True)
    (torch.stack([mul, add]) * probe).sum().backward()
    with tempfile.TemporaryDirectory() as d:
        torch.save({"x2": x2, "w": w, "probe": probe, "stride": 4,
                    "scale": bn.scale.detach(), "bias": bn.bias.detach()},
                   os.path.join(d, "gram_stats.pt"))
        ranks = launch_ranks(2, d, ["gram_stats"])["gram_stats"]
    # each rank's taps get dp times its rows' share; their dp mean (what
    # pmean_tree takes) is the global gradient
    torch.testing.assert_close((ranks[0]["dw"] + ranks[1]["dw"]) / 2,
                               wg.grad, atol=1e-5, rtol=1e-5)
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["mul"], mul.detach(), atol=1e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(out["add"], add.detach(), atol=1e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(out["mean"], bn.mean, atol=1e-6,
                                   rtol=1e-5)
        torch.testing.assert_close(out["var"], bn.var, atol=1e-6, rtol=1e-5)
        rows = slice(r * 40, (r + 1) * 40)
        torch.testing.assert_close(out["dx"], 2 * xg.grad[rows], atol=1e-5,
                                   rtol=1e-5)
