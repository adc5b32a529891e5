"""The port's encoder zoo against the JAX modules: gradients and train
mode (the forwards, the trees and the registry are in
``tests/test_torch_zoo.py``, whose shared inputs and weights these use).

Tolerances: gradients of ``scale · Σ feats · w``, per parameter, relative
L2 ≤ 1e-4; a gradient that vanishes in exact arithmetic is held against a
hundredth of the largest gradient instead. Train mode: where JAX's fields
turn every dropout off, the outputs (1e-4 · max|JAX|), the BatchNorm
running statistics after one step (1e-4) and the gradients as in eval
mode; elsewhere the BatchNorms ahead of the first dropout (1e-4) and each
dropout site's kept fraction within 3σ (JAX draws with threefry: the bits
cannot be equal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu_torch.models import (
    atm_e,
    baselines,
    eegnetv4,
    layers,
)
from eeg_image_decode_tpu_torch.utils.convert import params_from_flax
from test_torch_zoo import B, SIDS, X, ZOO, jax_case, port_model

#: the JAX fields that turn every dropout site off; the other three
#: encoders (NICE, ATM-E, EEGConformer) have sites no field reaches
DROPOUT_OFF = {
    "eegnetv4": {"dropout": 0.0}, "mlp": {"dropout": 0.0},
    "shallowfbcspnet": {"dropout": 0.0}, "eegitnet": {"dropout": 0.0},
    "metaeeg": {"dropout": 0.0},
    "atcnet": {"conv_dropout": 0.0, "att_dropout": 0.0, "tcn_dropout": 0.0},
}
#: BatchNorms ahead of the first dropout site of the dropout-on encoders
BN_BEFORE_DROPOUT = {"nice": ("encoder.enc_eeg.bn1", "encoder.enc_eeg.bn2"),
                     "atme": (), "eegconformer": ("encoder.bn",)}



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def loss_weights(d=1024):
    return np.random.default_rng(5).normal(size=(B, d)).astype(np.float32)


def jax_loss(model, variables, w, train):
    """(loss, new batch_stats) of ``scale · Σ feats · w``; in train mode
    the batch statistics are updated, and dropout draws from key 3."""
    def loss(params):
        v = {**variables, "params": params}
        if train:
            (feats, scale), upd = model.apply(
                v, jnp.asarray(X), jnp.asarray(SIDS), deterministic=False,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(3)})
        else:
            feats, scale = model.apply(v, jnp.asarray(X), jnp.asarray(SIDS),
                                       deterministic=True)
            upd = {}
        return scale * jnp.sum(feats * w), (feats, upd)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (value, (feats, upd)), grads = fn(variables["params"])
    return np.asarray(feats), jax.tree_util.tree_map(np.asarray, grads), upd


def port_loss(model, w, train):
    model.train(train)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(3)
    feats, scale = model(torch.from_numpy(X), torch.from_numpy(SIDS),
                         generator=gen)
    (scale * (feats.float() * torch.from_numpy(w)).sum()).backward()
    return feats.detach().float().numpy(), {
        k: p.grad.detach().numpy() for k, p in model.named_parameters()}


def assert_grads_close(name, got, want_tree, tol=1e-4):
    want = {k: v.numpy() for k, v in params_from_flax(
        {"params": want_tree}, encoder=name).items()}
    assert got.keys() == want.keys()
    norms = {k: np.linalg.norm(v) for k, v in want.items()}
    # a gradient that vanishes in exact arithmetic (the attention's key
    # bias under the softmax's shift invariance; a bias or scale ahead of
    # a train-mode BatchNorm, up to its eps) holds rounding noise on both
    # sides, of about 1e-7 of the largest gradient: each is held
    # against a hundredth of the largest gradient instead
    floor = 1e-2 * max(norms.values())
    worst = {k: np.linalg.norm(got[k] - want[k]) / max(norms[k], floor)
             for k in want}
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad


@pytest.mark.parametrize("name", ZOO)
def test_zoo_eval_gradients_match_flax(name):
    """Gradients of scale · Σ feats · w in eval mode, every parameter (the
    logit scale too): EEGNetV4's max-norm passes its gradient through."""
    jm, variables = jax_case(name)
    w = loss_weights()
    _, want, _ = jax_loss(jm, variables, jnp.asarray(w), train=False)
    _, got = port_loss(port_model(name, variables), w, train=False)
    assert_grads_close(name, got, want)


@pytest.fixture
def dropout_sites(monkeypatch):
    """Each drawn dropout site of a port forward: (p, nonzero inputs, kept
    of them)."""
    sites = []
    real = layers.dropout

    def spy(h, p, *, train, mask=None, generator=None):
        out = real(h, p, train=train, mask=mask, generator=generator)
        if train and p > 0 and mask is None:
            nz = h != 0
            sites.append((p, int(nz.sum()), int((out != 0)[nz].sum())))
        return out

    for mod in (layers, eegnetv4, atm_e, baselines):
        monkeypatch.setattr(mod, "dropout", spy)
    return sites


@pytest.mark.parametrize("name", ZOO)
def test_zoo_train_mode_against_flax(name, dropout_sites):
    w = loss_weights()
    if name in DROPOUT_OFF:
        fields = DROPOUT_OFF[name]
        jm, variables = jax_case(name, **fields)
        want, want_g, upd = jax_loss(jm, variables, jnp.asarray(w),
                                     train=True)
        model = port_model(name, variables, **fields)
        got, got_g = port_loss(model, w, train=True)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert_grads_close(name, got_g, want_g)
        stats = params_from_flax({"batch_stats": upd.get("batch_stats", {})},
                                 encoder=name)
        sd = model.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        assert not dropout_sites
        return
    jm, variables = jax_case(name)
    _, _, upd = jax_loss(jm, variables, jnp.asarray(w), train=True)
    model = port_model(name, variables)
    got, _ = port_loss(model, w, train=True)
    assert np.isfinite(got).all()
    stats = params_from_flax({"batch_stats": upd["batch_stats"]},
                             encoder=name)
    sd = model.state_dict()
    for bn in BN_BEFORE_DROPOUT[name]:
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                sd[f"{bn}.{leaf}"].numpy(), stats[f"{bn}.{leaf}"].numpy(),
                rtol=1e-4, atol=1e-4, err_msg=f"{bn}.{leaf}")
    assert dropout_sites
    for p, n, kept in dropout_sites:
        sigma = np.sqrt(p * (1 - p) / n)
        assert abs(kept / n - (1 - p)) <= 3 * sigma, (p, n, kept)
