"""The port's ATM-S eval forward against the JAX model on the same weights.

Weights: the JAX model's variables, every leaf redrawn from a numpy seed
(so biases, norm parameters and BatchNorm running statistics all matter),
carried into the port by ``utils/convert.py::params_from_flax``. Inputs:
the same numpy EEG and subject ids on both sides. Tolerance: fp32, JAX at
'highest' matmul precision (conftest.py), atol = rtol = 1e-3 for the whole
model — the two post-norm LayerNorms and the BatchNorms amplify the fp32
summation-order differences of the ops (1e-4 each, tests/test_torch_ops.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.utils.convert import (
    load_flat_npz,
    params_from_flax,
    save_flat_npz,
)
from torch_port_case import SMALL, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-3, atol=1e-3)

def jax_and_port(cfg_kw, eeg, sids, seed=0):
    """(JAX features, port features) of one forward on shared weights."""
    jax_model = jax_build_encoder("atms", config=JaxATMSConfig(**cfg_kw))
    variables = jax_model.init(jax.random.key(0), jnp.asarray(eeg[:2]),
                               jnp.asarray(sids[:2]), deterministic=True)
    variables = randomize(variables, seed)
    want, _ = jax_model.apply(variables, jnp.asarray(eeg), jnp.asarray(sids),
                              deterministic=True)
    port_kw = {k: v for k, v in cfg_kw.items()
               if k in {f.name for f in dataclasses.fields(ATMSConfig)}}
    model = build_encoder("atms", config=ATMSConfig(**port_kw), device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got, scale = model(torch.from_numpy(eeg), torch.from_numpy(sids))
    assert float(scale.detach()) == pytest.approx(2.6592600225)
    return np.asarray(want), got.numpy(), variables


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"fused_attention": True},
    {"fused_projection": True},
    {"fused_tsconv": True},      # the JAX TPU tree: temporal_conv_kernel (K, F)
    {"exact_gelu": True},
], ids=["default", "fused_attention", "fused_projection", "fused_tsconv",
        "exact_gelu"])
@pytest.mark.parametrize("sids", [[0, 1, 2, 1], [0, 1, 7, 2]],
                         ids=["in_range", "one_out_of_range"])
def test_small_atms_matches_jax(cfg_kw, sids):
    rng = np.random.default_rng(11)
    eeg = rng.normal(size=(4, 8, 100)).astype(np.float32)
    want, got, _ = jax_and_port({**SMALL, **cfg_kw}, eeg,
                                np.asarray(sids, np.int32))
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_out_of_range_subject_switches_the_whole_batch():
    """One id ≥ num_subjects gives every row the shared token: row 0's
    features then differ from those of the same row in an in-range batch."""
    rng = np.random.default_rng(12)
    eeg = rng.normal(size=(2, 8, 100)).astype(np.float32)
    _, in_range, _ = jax_and_port(SMALL, eeg, np.asarray([0, 1], np.int32))
    _, oor, _ = jax_and_port(SMALL, eeg, np.asarray([0, 5], np.int32))
    assert np.abs(in_range[0] - oor[0]).max() > 1e-2


def test_full_width_atms_matches_jax(tmp_path):
    """ATMSConfig() defaults (63 × 250, d_model 250, 1440 → 1024), B = 2;
    the weights also cross through the CLI's flat .npz file."""
    rng = np.random.default_rng(13)
    eeg = rng.normal(size=(2, 63, 250)).astype(np.float32)
    sids = np.asarray([1, 4], np.int32)
    want, got, variables = jax_and_port({}, eeg, sids)
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, **TOL)

    path = tmp_path / "atms.npz"
    save_flat_npz(variables, str(path))
    direct = params_from_flax(variables)
    via_file = params_from_flax(load_flat_npz(str(path)))
    assert direct.keys() == via_file.keys()
    for k in direct:
        torch.testing.assert_close(via_file[k], direct[k], rtol=0, atol=0)


def test_unported_encoders_and_training_raise():
    """An encoder name the registry does not hold raises ``KeyError``, as
    in JAX (every JAX name is ported; ``tests/test_torch_zoo.py``).
    Joint-train subject embeddings and training through the fused
    projection head (its dropout modes and backward) are ported and run, as
    training the default model does."""
    with pytest.raises(KeyError, match="unknown encoder"):
        build_encoder("nicer", device="cpu")
    x, sids = torch.zeros(2, 8, 100), torch.zeros(2, dtype=torch.int32)
    model = build_encoder("atms", config=ATMSConfig(**SMALL, joint_train=True),
                          device="cpu")
    assert model.encoder.embedding.subject_value_w.shape == (3, 100, 32)
    assert model(x, sids)[0].shape == (2, 16)
    model = build_encoder("atms", config=ATMSConfig(**SMALL,
                                                    fused_projection=True),
                          device="cpu")
    feats, _ = model.train()(x, sids)
    feats.sum().backward()
    assert feats.shape == (2, 16)
    assert model.encoder.proj_eeg.in_proj.kernel.grad is not None
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu")
    feats, _ = model.train()(x, sids)
    assert feats.shape == (2, 16)


def test_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_encoder("atms", config=ATMSConfig(**SMALL))


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_drawn_dropout_divides_by_keep_prob_as_flax(p):
    """The drawn dropout in bfloat16 equals flax's ``inputs / keep_prob``
    on the same keep pattern, bit for bit. At p = 0.25 a product with the
    rounded factor 1/0.75 (1.3359 in bfloat16) gives other bits; at p = 0.5
    both formulas are exact (× 2)."""
    import flax.linen as fnn

    from eeg_image_decode_tpu_torch.models.layers import dropout

    x = np.random.default_rng(31).normal(size=(64, 250)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dropout(xb, p, train=True,
                  generator=torch.Generator().manual_seed(3))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) >= p
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jnp.where(jnp.asarray(keep.numpy()), xj / (1.0 - p),
                     jnp.zeros_like(xj))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the formula is flax's own: nn.Dropout's output on its own pattern
    out = fnn.Dropout(rate=p, deterministic=False).apply(
        {}, xj, rngs={"dropout": jax.random.key(4)})
    flax_keep = out != 0
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(jnp.where(flax_keep, xj / (1.0 - p), 0)))
    rounded = (xb * torch.tensor(1.0 / (1.0 - p)).to(torch.bfloat16)) * keep
    assert torch.equal(got, rounded) == (p == 0.5)
