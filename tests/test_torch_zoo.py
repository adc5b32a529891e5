"""The port's encoder zoo against the JAX modules on the same weights.

The nine encoders of the registry besides ATM-S (``models/nice.py``,
``eegnetv4.py``, ``atm_e.py``, ``baselines.py``), each at its JAX defaults,
which are the published widths: B 4 of (63, 250) EEG made from a numpy
seed. Weights: the JAX tree (shapes from ``jax.eval_shape``) with every
leaf redrawn from a numpy seed (``torch_port_case.randomize``), carried
into the port by ``utils/convert.py::params_from_flax`` and loaded
strictly. JAX's side runs under ``jax.jit`` at 'highest' matmul precision
(conftest.py).

Tolerances: the eval forward in fp32 within 1e-4 · max|JAX| (fp32
summation order only); bf16 against JAX's bf16 module at per-row cosine
≥ 0.99 (both round at the same points, but XLA and PyTorch sum bf16
products in other orders). Flax's attention dropout: one (L, L) mask
shared by every sample and head. The gradients and train mode are in
``tests/test_torch_zoo_train.py``.
"""

import importlib.util
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models import layers
from eeg_image_decode_tpu_torch.models.registry import (
    ENCODERS,
    build_encoder,
)
from eeg_image_decode_tpu_torch.utils.convert import (
    encoder_name_of,
    params_from_flax,
)
from torch_port_case import SMALL, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ("nice", "eegnetv4", "atme", "mlp", "shallowfbcspnet",
       "eegconformer", "metaeeg", "atcnet", "eegitnet")
B = 4
X = np.random.default_rng(20200220).normal(size=(B, 63, 250)).astype(
    np.float32)
SIDS = np.zeros(B, np.int32)
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


_TREES: dict = {}


def jax_case(name, **fields):
    """(the JAX model, its randomized variables) for ``name`` at its
    defaults overridden by ``fields``; the tree's shapes from
    ``jax.eval_shape``."""
    key = (name, tuple(sorted(fields.items())))
    if key not in _TREES:
        model = jax_build_encoder(name, **fields)
        shapes = jax.eval_shape(
            partial(model.init, deterministic=True), jax.random.key(0),
            jnp.zeros((2, 63, 250)), jnp.zeros((2,), jnp.int32))
        _TREES[key] = model, randomize(shapes, 7)
    return _TREES[key]


def port_model(name, variables, dtype=torch.float32, **fields):
    model = build_encoder(name, dtype=dtype, device="cpu", **fields)
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("name", ZOO)
def test_zoo_tree_loads_strictly_with_the_flax_count(name):
    """The JAX tree loads with ``strict=True`` under the JAX names; the
    parameter count equals the flax tree's and the constant
    ``chip_smoke.py`` holds the card's models to (the card host has no
    JAX); the encoder is told from the tree."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, variables = jax_case(name)
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(
        variables["params"]))
    model = port_model(name, variables)
    assert sum(p.numel() for p in model.parameters()) == n_flax
    assert smoke.ZOO_PARAMS[name] == n_flax
    assert encoder_name_of(variables["params"]) == name


@pytest.mark.parametrize("name", ZOO)
def test_zoo_eval_forward_matches_flax(name):
    jm, variables = jax_case(name)
    want, _ = jax.jit(partial(jm.apply, deterministic=True))(
        variables, jnp.asarray(X), jnp.asarray(SIDS))
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = port_model(name, variables)(torch.from_numpy(X),
                                             torch.from_numpy(SIDS))
    assert got.shape == want.shape == (B, 1024)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", ZOO)
def test_zoo_bf16_forward_against_flax_bf16(name):
    _, variables = jax_case(name)
    jm = jax_build_encoder(name, dtype=jnp.bfloat16)
    want, _ = jax.jit(partial(jm.apply, deterministic=True))(
        variables, jnp.asarray(X), jnp.asarray(SIDS))
    want = np.asarray(want, np.float32)
    with torch.no_grad():
        got, _ = port_model(name, variables, torch.bfloat16)(
            torch.from_numpy(X), torch.from_numpy(SIDS))
    got = got.float().numpy()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert np.isfinite(got).all() and cos.min() >= 0.99, cos


def test_attention_dropout_is_one_mask_for_the_batch_and_heads():
    """flax's ``broadcast_dropout``: the (L, L) keep pattern drawn once
    per call, shared by every sample and head, times keep / (1 − p) in the
    working dtype; its kept fraction within 3σ."""
    torch.manual_seed(0)
    mha = layers.MultiHeadDotProductAttention(16, 2, dropout=0.5)
    for p in mha.parameters():
        p.data.normal_(0, 0.3)
    x = torch.randn(1, 17, 16).repeat(3, 1, 1)   # three equal samples
    out = mha(x, torch.float32, train=True,
              generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    torch.testing.assert_close(out[0], out[2], rtol=0, atol=0)
    keep = torch.rand((17, 17), generator=torch.Generator().manual_seed(1)
                      ) < 0.5
    sigma = np.sqrt(0.25 / keep.numel())
    assert abs(keep.float().mean().item() - 0.5) <= 3 * sigma
    # the same forward with that pattern spelled out
    h, hd = 2, 8

    def proj(m):
        return (x @ m.kernel.reshape(16, h * hd)).reshape(3, 17, h, hd) \
            .add(m.bias).transpose(1, 2)

    q, k, v = proj(mha.query), proj(mha.key), proj(mha.value)
    wts = torch.softmax((q / np.sqrt(hd)) @ k.transpose(-1, -2), -1)
    o = (wts * keep / 0.5) @ v
    want = o.transpose(1, 2).reshape(3, 17, 16) @ mha.out.kernel.reshape(
        16, 16) + mha.out.bias
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert not torch.equal(out, mha(x, torch.float32))


def test_grouped_conv_channels_are_group_major():
    """A depthwise HWIO kernel with ``feature_group_count`` 8 and 160
    outputs: output channel o reads input group o // 20, in XLA as in
    ``F.conv2d`` (``layers.conv``) and in the batched product over the
    electrodes (``layers.electrode_conv``)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 63, 9, 8)).astype(np.float32)       # NHWC
    w = rng.normal(size=(63, 1, 1, 160)).astype(np.float32)     # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=8))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layers.conv(nchw, torch.from_numpy(w), torch.float32, groups=8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    product = layers.electrode_conv(nchw, torch.from_numpy(w),
                                    torch.float32)
    np.testing.assert_allclose(product.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # channel 20 reads input channel 1 only
    one = np.zeros_like(x)
    one[..., 1] = x[..., 1]
    alone = layers.conv(torch.from_numpy(one).permute(0, 3, 1, 2),
                        torch.from_numpy(w), torch.float32, groups=8)
    assert alone[:, 20:40].abs().max() > 0
    assert alone[:, :20].abs().max() == 0 and alone[:, 40:].abs().max() == 0


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_same_padding_puts_the_odd_tap_high_as_xla(dilation):
    """EEGITNet's dilated k = 4 convolutions under XLA's ``"SAME"``: the
    total 3·dilation split ⌊total/2⌋ low, the rest high."""
    rng = np.random.default_rng(dilation)
    x = rng.normal(size=(2, 1, 62, 6)).astype(np.float32)
    w = rng.normal(size=(1, 4, 6, 6)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        rhs_dilation=(1, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = layers.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w), torch.float32,
                      padding=((0, 0), layers.same_padding(4, dilation)),
                      dilation=(1, dilation))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_registry_builds_every_name_with_jax_logit_scale(name):
    kw = {"config": ATMSConfig(**SMALL)} if name == "atms" else {}
    model = build_encoder(name.upper(), device="cpu", **kw)
    assert not model.training
    want = np.log(1 / 0.01) if name in ("mlp", "metaeeg") else 2.6592600225
    assert model.logit_scale().item() == pytest.approx(want)
    shape = (2, 8, 100) if name == "atms" else (2, 63, 250)
    with torch.no_grad():
        feats, _ = model(torch.zeros(shape), torch.zeros(2, dtype=torch.int32))
    assert feats.shape[0] == 2 and torch.isfinite(feats).all()


def test_registry_refuses_unknown_names_misplaced_config_and_no_card():
    with pytest.raises(KeyError, match="unknown encoder"):
        build_encoder("eegnet", device="cpu")
    with pytest.raises(TypeError, match="ATM-S"):
        build_encoder("nice", config=ATMSConfig(), device="cpu")
    with pytest.raises(TypeError):  # the hook is ATM-S's only
        build_encoder("eegnetv4", device="cpu")(
            torch.zeros(2, 63, 250), dropout_masks={})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_encoder("nice")


def test_converter_keeps_zoo_layouts_and_atms_mapping():
    """EEGNetV4's ``temporal_conv`` and EEGConformer's ``proj_conv`` keep
    their HWIO kernels (the tsconv rules of the same names are ATM-S's and
    NICE's); ATM-S's mapping is unchanged, told or inferred."""
    for name, key in (("eegnetv4", "temporal_conv"),
                      ("eegconformer", "proj_conv")):
        _, variables = jax_case(name)
        want = variables["params"]["encoder"][key]["kernel"]
        sd = params_from_flax(variables)
        np.testing.assert_array_equal(sd[f"encoder.{key}.kernel"].numpy(),
                                      want)
        assert f"encoder.{key}_kernel" not in sd
    jm = jax_build_encoder("atms", config=_jax_atms_config())
    shapes = jax.eval_shape(
        partial(jm.init, deterministic=True), jax.random.key(0),
        jnp.zeros((2, 8, 100)), jnp.zeros((2,), jnp.int32))
    variables = randomize(shapes, 8)
    p = variables["params"]["encoder"]["enc_eeg"]
    told = params_from_flax(variables, encoder="atms")
    inferred = params_from_flax(variables)
    assert told.keys() == inferred.keys()
    for k in told:
        torch.testing.assert_close(told[k], inferred[k], rtol=0, atol=0)
    t = p["temporal_conv"]["kernel"]
    np.testing.assert_array_equal(
        told["encoder.enc_eeg.temporal_conv_kernel"].numpy(),
        t.reshape(t.shape[1], -1))
    s = p["spatial_conv"]["kernel"]
    np.testing.assert_array_equal(
        told["encoder.enc_eeg.spatial_conv.kernel"].numpy(),
        s.reshape(s.shape[0] * s.shape[2], s.shape[3]))
    build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu"
                  ).load_state_dict(told, strict=True)


def _jax_atms_config():
    from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig

    return JaxATMSConfig(**SMALL)


def test_nice_loads_both_tsconv_layouts():
    """JAX's NICE tree has the plain conv's HWIO ``temporal_conv/kernel``
    off the TPU and the folded kernel's ``temporal_conv_kernel`` on it
    (``fused_tsconv``): both load into the port and give JAX's features."""
    _, plain = jax_case("nice")
    jm, fused = jax_case("nice", fused_tsconv=True)
    assert "temporal_conv_kernel" in fused["params"]["encoder"]["enc_eeg"]
    assert "temporal_conv" in plain["params"]["encoder"]["enc_eeg"]
    want, _ = jax.jit(partial(jm.apply, deterministic=True))(
        fused, jnp.asarray(X), jnp.asarray(SIDS))
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = port_model("nice", fused)(torch.from_numpy(X))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    port_model("nice", plain)

