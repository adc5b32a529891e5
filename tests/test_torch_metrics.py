"""The port's reconstruction metrics (``eval/recon_metrics.py``) against the
JAX package's, fp32 on the CPU: each function on the same seeded inputs at
≤ 1e-5 absolute, the 2-way rows equal (ties counted as losses on both
sides), the antialiased resize against ``jax.image.resize`` at the table's
sizes at ≤ 2e-5, the CLIP extractor on a tiny ViT-L-style tower (quick
GELU) with JAX's tree carried across, and ``reconstruction_metrics``' keys
in order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_image_decode_tpu.eval import recon_metrics as jrm
from eeg_image_decode_tpu.models import clip_vit as jclip
from eeg_image_decode_tpu_torch.eval import recon_metrics as prm
from eeg_image_decode_tpu_torch.models import clip_vit as pclip
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_tree_from_state_dict,
)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pair(seed, shape=(5, 24, 24, 3), noise=0.3):
    rng = np.random.default_rng(seed)
    gen = rng.uniform(size=shape).astype(np.float32)
    gt = np.clip(gen + noise * rng.normal(size=shape), 0, 1).astype(
        np.float32)
    return gen, gt


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["pixcorr", "ssim", "feature_distance",
                                  "two_way_identification"])
def test_metric_matches_jax(name):
    gen, gt = _pair(1)
    got = getattr(prm, name)(torch.from_numpy(gen), torch.from_numpy(gt))
    want = getattr(jrm, name)(jnp.asarray(gen), jnp.asarray(gt))
    assert got.ndim == 0
    _close(got, want)


@pytest.mark.parametrize("data_range,window,sigma",
                         [(1.0, 11, 1.5), (255.0, 7, 1.0)])
def test_ssim_options_and_grayscale_match_jax(data_range, window, sigma):
    gen, gt = _pair(2, shape=(3, 20, 18, 3))
    gen, gt = gen * data_range, gt * data_range
    got = prm.ssim(torch.from_numpy(gen), torch.from_numpy(gt),
                   data_range=data_range, window_size=window, sigma=sigma)
    want = jrm.ssim(jnp.asarray(gen), jnp.asarray(gt),
                    data_range=data_range, window_size=window, sigma=sigma)
    _close(got, want, TOL * data_range)
    _close(prm.to_grayscale(torch.from_numpy(gen)),
           jrm.to_grayscale(jnp.asarray(gen)), TOL * data_range)
    np.testing.assert_array_equal(prm._gaussian_window(window, sigma),
                                  jrm._gaussian_window(window, sigma))


def test_rowwise_corr_guards_a_constant_row():
    """A constant row has a zero denominator: the 1e-12 guard makes its
    correlation 0 on both sides."""
    a, b = _pair(3, shape=(4, 30))
    a[1] = 0.25
    got = prm._rowwise_corr(torch.from_numpy(a), torch.from_numpy(b))
    want = jrm._rowwise_corr(jnp.asarray(a), jnp.asarray(b))
    _close(got, want)
    assert float(got[1]) == 0.0


def test_two_way_ties_count_as_losses_like_jax():
    """Duplicated ground-truth rows and a constant row give tied
    correlations; strict ``>`` counts every tie as a loss, in both."""
    rng = np.random.default_rng(4)
    gen = rng.normal(size=(6, 40)).astype(np.float32)
    gt = gen + 0.5 * rng.normal(size=gen.shape).astype(np.float32)
    gt[3] = gt[2]   # gen_2 and gen_3 tie against gt_2 / gt_3
    gt[5] = 1.0     # a constant row: every correlation with it is 0
    gen[4] = -2.0   # a constant generated row: its row of corr is all 0
    got = float(prm.two_way_identification(torch.from_numpy(gen),
                                           torch.from_numpy(gt)))
    want = float(jrm.two_way_identification(jnp.asarray(gen),
                                            jnp.asarray(gt)))
    assert got == want
    # the inputs do tie: counting ties as wins would give another value
    g = gen - gen.mean(1, keepdims=True)
    t = gt - gt.mean(1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True) + 1e-12
    t /= np.linalg.norm(t, axis=1, keepdims=True) + 1e-12
    corr = g.astype(np.float64) @ t.T.astype(np.float64)
    ties = (np.diag(corr)[:, None] == corr).sum() - len(corr)
    assert ties >= 6
    assert got <= 1.0 - ties / 30


def test_two_way_resolves_near_ties_at_alexnet_width():
    """AlexNet(5)-wide features (57,600) whose correlations lie within 1e-3
    of each other (the smallest gap 1.4e-5 at this seed): the port's 2-way
    row and JAX's both equal the count taken in float64. JAX's float32
    correlations, computed as ``two_way_identification`` computes them, lie
    within 1e-6 of float64's (2.2e-7 at this seed), well under that gap."""
    rng = np.random.default_rng(8)
    base = rng.uniform(size=57600)
    gen = (base + 0.9 * rng.uniform(size=(4, 57600))).astype(np.float32)
    gt = (base + 0.9 * rng.uniform(size=(4, 57600))).astype(np.float32)
    g = gen - gen.mean(1, keepdims=True, dtype=np.float64)
    t = gt - gt.mean(1, keepdims=True, dtype=np.float64)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    corr = g @ t.T
    gaps = np.abs(np.diag(corr)[:, None] - corr)[~np.eye(4, dtype=bool)]
    assert 1e-6 < gaps.min() < 1e-3
    want = ((np.diag(corr)[:, None] > corr).sum()) / 12
    got = float(prm.two_way_identification(torch.from_numpy(gen),
                                           torch.from_numpy(gt)))
    assert got == pytest.approx(want, abs=1e-7)
    assert float(jrm.two_way_identification(jnp.asarray(gen),
                                            jnp.asarray(gt))) == got
    jg, jt = (v - v.mean(1, keepdims=True) for v in (jnp.asarray(gen),
                                                     jnp.asarray(gt)))
    jg = jg / (jnp.linalg.norm(jg, axis=1, keepdims=True) + 1e-12)
    jt = jt / (jnp.linalg.norm(jt, axis=1, keepdims=True) + 1e-12)
    assert np.abs(np.asarray(jg @ jt.T, np.float64) - corr).max() < 1e-6


@pytest.mark.parametrize("src,dst", [(512, 425), (425, 256), (425, 342),
                                     (425, 255), (425, 224), (64, 256),
                                     (20, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(src + dst)
    x = rng.uniform(size=(2, src, src, 3)).astype(np.float32)
    got = prm.resize_bilinear(torch.from_numpy(x), dst)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "bilinear")
    assert got.shape == (2, dst, dst, 3)
    _close(got, want, 2e-5)


def _tiny_clip(seed=0):
    cfg = pclip.CLIPVisionConfig.tiny("quick_gelu")
    tower = pclip.CLIPVisionTower(cfg, seed=seed).eval()
    tree = clip_tree_from_state_dict(tower.state_dict(), "vision", cfg.heads)
    return tower, jclip.CLIPVisionTower(jclip.CLIPVisionConfig.tiny(
        "quick_gelu")), tree


@pytest.mark.parametrize("size", [32, 48])
def test_clip_extractor_matches_jax(size):
    """Images at 48 px are resized to the tower's 32 first."""
    tower, jtower, tree = _tiny_clip()
    gen, _ = _pair(5, shape=(3, size, size, 3))
    got = prm.make_clip_extractor(tower)(torch.from_numpy(gen))
    want = jrm.make_clip_extractor(jtower, tree)(jnp.asarray(gen))
    assert got.shape == (3, 32)
    _close(torch.linalg.norm(got, dim=-1), np.ones(3))
    _close(got, want)


def test_reconstruction_metrics_matches_jax():
    """Two extractors: the tiny CLIP and a fixed random projection; the
    keys in JAX's insertion order, every value within 1e-5, Python
    floats."""
    tower, jtower, tree = _tiny_clip(1)
    gen, gt = _pair(6, shape=(4, 32, 32, 3), noise=0.1)
    proj = np.random.default_rng(7).normal(
        size=(32 * 32 * 3, 16)).astype(np.float32)
    pe = {"clip": prm.make_clip_extractor(tower),
          "proj": lambda x: x.reshape(x.shape[0], -1) @ torch.from_numpy(
              proj)}
    je = {"clip": jrm.make_clip_extractor(jtower, tree),
          "proj": lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(proj)}
    got = prm.reconstruction_metrics(torch.from_numpy(gen),
                                     torch.from_numpy(gt), pe)
    want = jrm.reconstruction_metrics(jnp.asarray(gen), jnp.asarray(gt), je)
    assert list(got) == list(want) == [
        "pixcorr", "ssim", "2way_clip", "dist_clip", "2way_proj",
        "dist_proj"]
    assert all(type(v) is float for v in got.values())
    for k in want:
        if k.startswith("2way"):
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert list(prm.reconstruction_metrics(
        torch.from_numpy(gen), torch.from_numpy(gt))) == ["pixcorr", "ssim"]
