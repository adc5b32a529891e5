"""The port's preprocessing functions against the JAX package's, on the CPU.

- Ledoit-Wolf covariances, batched (in chunks) and one epoch alone: rtol
  1e-12 (both float64; only the summation order differs).
- ``matrix_inverse_sqrt``: rtol 1e-10 (eigenvector signs may differ, V·diag·Vᵀ
  does not).
- The session covariance (rtol 1e-12) and ``mvnn_whiten`` (float32: within
  1e-5 of the largest value).
- The polyphase resample against scipy's ``resample_poly`` (the JAX
  package's call), its first and last samples included: within 1e-10 of the
  largest value, for several rate pairs.
- ``epoch_session`` on one written raw session: the conditions and times
  equal, the float32 epochs within one unit in the last place, so the
  chosen reps are the same; the merges equal; the pickle readable by the
  port's loader.
- ``build_images_set`` and ``load_things_metadata``: the same counts and the
  same files.
"""

import os

import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.preprocess import epoching as jax_epoching
from eeg_image_decode_tpu.preprocess import images_set as jax_images_set
from eeg_image_decode_tpu.preprocess import mvnn as jax_mvnn
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_raw_session,
)
from eeg_image_decode_tpu_torch.data.things_eeg import _load_subject_file
from eeg_image_decode_tpu_torch.preprocess import epoching, images_set, mvnn


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _epochs(rng, n, t=251, c=9):
    """Correlated channels, as EEG's are."""
    mix = rng.normal(size=(c, c))
    return np.einsum("ij,njt->nit", mix, rng.normal(size=(n, c, t)))


def test_ledoit_wolf_batched_and_scalar_match_jax(rng):
    x = rng.normal(size=(11, 40, 9)) @ rng.normal(size=(9, 9))
    x[3] *= 1e-6   # near-degenerate: the shrinkage clamp
    x[5] = 0.0     # Δ = 0: no shrinkage
    want = jax_mvnn.ledoit_wolf_cov_batched(x)
    got = mvnn.ledoit_wolf_cov_batched(_t(x), chunk=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    for i in (0, 3, 7):
        np.testing.assert_allclose(
            mvnn.ledoit_wolf_cov(_t(x[i])).numpy(),
            jax_mvnn.ledoit_wolf_cov(x[i]), rtol=1e-12, atol=0)
    before = x.copy()
    mvnn.ledoit_wolf_cov_batched(_t(x))
    np.testing.assert_array_equal(x, before)  # the caller's array is kept


def test_matrix_inverse_sqrt_matches_jax(rng):
    a = rng.normal(size=(12, 12))
    for sigma in (a @ a.T + 0.1 * np.eye(12),
                  np.diag([1.0, 1e-20, 2.0])):  # clamped eigenvalue
        np.testing.assert_allclose(
            mvnn.matrix_inverse_sqrt(_t(sigma)).numpy(),
            jax_mvnn.matrix_inverse_sqrt(sigma), rtol=1e-10, atol=0)


def test_session_covariance_and_whiten_match_jax(rng):
    train = [_epochs(rng, 12).reshape(6, 2, 9, 251).astype(np.float32)
             for _ in range(2)]
    test = [_epochs(rng, 6).reshape(3, 2, 9, 251).astype(np.float32)
            for _ in range(2)]
    np.testing.assert_allclose(
        mvnn.session_covariance(_t(train[0]), chunk=5).numpy(),
        jax_mvnn.session_covariance(train[0]), rtol=1e-12, atol=0)
    want_tr, want_te = jax_mvnn.mvnn_whiten(train, test)
    got_tr, got_te = mvnn.mvnn_whiten([_t(a) for a in train],
                                      [_t(a) for a in test])
    for got, want in zip(got_tr + got_te, want_tr + want_te):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("up,down", [(1, 4), (250, 1000), (1, 10), (3, 10),
                                     (5, 3), (2, 1)])
def test_resample_matches_scipy_at_its_edges(rng, up, down):
    x = rng.normal(size=(3, 4, 1201)) + 2.0  # an offset shows the padding
    want = jax_epoching.resample_poly(x, up // np.gcd(up, down),
                                      down // np.gcd(up, down))
    got = epoching.resample_poly(_t(x), up, down).numpy()
    assert got.shape == want.shape
    tol = 1e-10 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for edge in (slice(0, 3), slice(-3, None)):  # the filter's delay
        np.testing.assert_allclose(got[..., edge], want[..., edge], rtol=0,
                                   atol=tol)


@pytest.fixture(scope="module")
def session():
    raw = make_synthetic_raw_session(12, 3, images_per_class=3,
                                     target_every=7, seed=5)
    stim_row = raw["ch_names"].index("stim")
    rows = [i for i in range(len(raw["ch_names"])) if i != stim_row]
    return (raw["raw_eeg_data"][rows], [raw["ch_names"][i] for i in rows],
            raw["raw_eeg_data"][stim_row])


@pytest.mark.parametrize("sfreq,max_rep", [(250, 2), (100, 3), (1000, 2)])
def test_epoch_session_matches_jax(session, sfreq, max_rep):
    raw, ch_names, stim = session
    want, want_c, want_t = jax_epoching.epoch_session(
        raw, ch_names, 1000.0, stim, target_sfreq=sfreq, max_rep=max_rep,
        seed=9)
    got, got_c, got_t = epoching.epoch_session(
        raw, ch_names, 1000.0, stim, target_sfreq=sfreq, max_rep=max_rep,
        seed=9, device="cpu", chunk=5)
    assert epoching.TARGET_EVENT not in got_c
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_t, want_t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_events_and_selection_match_jax(session):
    _, _, stim = session
    np.testing.assert_array_equal(epoching.find_events(stim),
                                  jax_epoching.find_events(stim))
    np.testing.assert_array_equal(
        epoching.find_events(np.array([0, 0, 5, 5, 0, 7, 0, 99999])),
        [[2, 5], [5, 7], [7, 99999]])
    values = np.array([3, 1, 3, 2, 1, 2, 3, 1])
    conds, picks = epoching.select_epochs(values, 2, seed=4)
    np.testing.assert_array_equal(conds, [1, 2, 3])
    rng = np.random.RandomState(4)  # the JAX loop's draws, in order
    for c, p in zip(conds, picks):
        idx = np.nonzero(values == c)[0]
        np.testing.assert_array_equal(p, idx[rng.permutation(len(idx))[:2]])


def test_merges_and_pickle_match_jax(tmp_path, rng):
    s = [rng.normal(size=(3, 2, 4, 10)).astype(np.float32) for _ in range(2)]
    conds = [np.array([1, 2, 3]), np.array([1, 2, 3])]
    np.testing.assert_array_equal(
        epoching.merge_sessions_test(s, seed=2),
        jax_epoching.merge_sessions_test(s, seed=2))
    merged = epoching.merge_sessions_train(s, conds, seed=2)
    np.testing.assert_array_equal(
        merged, jax_epoching.merge_sessions_train(s, conds, seed=2))
    path = str(tmp_path / "sub-01" / "preprocessed_eeg_training.npy")
    epoching.save_preprocessed(path, merged, epoching.CHANNEL_ORDER[:4],
                               np.linspace(0, 1, 10))
    d = _load_subject_file(str(tmp_path), "sub-01", train=True)
    np.testing.assert_array_equal(d["preprocessed_eeg_data"], merged)
    assert epoching.CHANNEL_ORDER == jax_epoching.CHANNEL_ORDER


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_build_images_set_matches_jax(tmp_path):
    src = tmp_path / "src"
    paths = [f"images/{c}/{c}_{i}.jpg" for c in ("aardvark", "zebra", "yak")
             for i in range(3)] + ["flat.jpg"]
    for i, p in enumerate(paths):
        os.makedirs(src / os.path.dirname(p), exist_ok=True)
        (src / p).write_bytes(bytes([i]) * (i + 1))
    (tmp_path / "paths.csv").write_text("\n".join(paths) + "\n")
    (tmp_path / "concepts.csv").write_text(
        "\n".join(str(c) for c in [1, 1, 1, 2, 2, 2, 3, 3, 3, 4]) + "\n")
    meta = [str(tmp_path / "paths.csv"), str(tmp_path / "concepts.csv")]
    got_meta = images_set.load_things_metadata(*meta)
    assert got_meta == jax_images_set.load_things_metadata(*meta)
    assert images_set.concept_folder_name(7, "aardvark") == "00007_aardvark"
    kw = dict(train_event_ids=[1, 2, 4, 5, 10], test_event_ids=[3, 7],
              origin_dir=str(src))
    got = images_set.build_images_set(*got_meta, out_dir=str(tmp_path / "a"),
                                      **kw)
    want = jax_images_set.build_images_set(*got_meta,
                                           out_dir=str(tmp_path / "b"), **kw)
    assert got == want == {"training": 5, "test": 2, "skipped": 3}
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")
    assert "training_images/images/00002_zebra/zebra_1.jpg" in _tree(
        tmp_path / "a")
