"""The port's ``cli metrics --device cpu`` against the JAX CLI on the same
files: the same keys in the same order, values within 1e-5, the 2-way rows
equal, the CSV equal to the printed row. Inputs: a ``cli generate`` tree,
a flat directory, an ``.npy`` array (0-255, at another size), an ``.npz``
([0, 1], at another size), a tree read
in ``--class-names`` order (names that do not sort alphabetically);
``--backbone-params`` written from the port's seeded AlexNet and
``--clip-params`` from a tiny ViT-L-style tower (both packages'
``CLIPVisionConfig.vit_l_14`` patched to it). The count-mismatch and
missing-directory errors, and the refusal without a card."""

import contextlib
import io
import json
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from eeg_image_decode_tpu import cli as jcli
from eeg_image_decode_tpu.models import clip_vit as jclip
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.eval import backbones as pbb
from eeg_image_decode_tpu_torch.models import clip_vit as pclip
from eeg_image_decode_tpu_torch.utils.convert import (
    backbone_tree_from_state_dict,
)
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_tree_from_state_dict,
)

N = 4
SIZE = 32  # --image-size: the tiny tower's own size
#: class directories that do not sort in test-class order
NAMES = ("zebra", "apple", "mango", "kiwi")
#: generated image i = w · gt_i + (1 − w) · gt_j: rows that win, lose and
#: split their 2-way comparisons by clear margins (correlation gaps of
#: 1e-2 and more), so the rows test the scoring and not chance. Pairs of
#: unrelated noise images would give 2-way rows near chance, decided by
#: far smaller gaps; near ties are held in ``test_torch_metrics.py::
#: test_two_way_resolves_near_ties_at_alexnet_width``.
MIX = ((0, 1, 0.6), (1, 2, 0.6), (2, 3, 0.4), (3, 1, 0.3))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("metrics")
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, size=(N, 48, 48, 3)).astype(np.float32)
    gen = np.stack([w * gt[i] + (1 - w) * gt[j] for i, j, w in MIX])
    os.makedirs(d / "gt")
    for i in range(N):
        Image.fromarray(gt[i].astype(np.uint8)).save(
            d / "gt" / (f"{i:02d}.jpg" if i == 1 else f"{i:02d}.png"))
    for root, names in (("generated", [f"class_{i:04d}" for i in range(N)]),
                        ("named", NAMES)):
        for i, cls in enumerate(names):
            os.makedirs(d / root / cls)
            for seed in (0, 1):
                img = np.clip(gen[i] + 8 * seed * rng.normal(
                    size=gen[i].shape), 0, 255).astype(np.uint8)
                Image.fromarray(img).resize((40, 40), Image.BILINEAR).save(
                    d / root / cls / f"{seed}.png")
    np.save(d / "gen.npy", gen[:, ::2, ::2])  # 0-255 at 24 px
    np.savez(d / "gen.npz", images=gen[:, ::3, ::3] / 255.0)  # [0, 1], 16 px
    np.save(d / "gt2.npy", rng.uniform(size=(N - 1, SIZE, SIZE, 3)).astype(
        np.float32))
    (d / "names.txt").write_text("\n".join(NAMES) + "\n")
    (d / "names_missing.txt").write_text("\n".join(NAMES + ("fig",)) + "\n")
    alex = pbb.init_random(pbb.AlexNetFeatures(), 1)
    with open(d / "backbones.pkl", "wb") as f:
        pickle.dump({"alexnet": backbone_tree_from_state_dict(
            "alexnet", alex.state_dict())}, f)
    cfg = pclip.CLIPVisionConfig.tiny("quick_gelu")
    with open(d / "clip.pkl", "wb") as f:
        pickle.dump(clip_tree_from_state_dict(
            pclip.CLIPVisionTower(cfg, seed=2).state_dict(), "vision",
            cfg.heads), f)
    return d


@contextlib.contextmanager
def _tiny_vit_l():
    with mock.patch.object(jclip.CLIPVisionConfig, "vit_l_14", staticmethod(
            lambda: jclip.CLIPVisionConfig.tiny("quick_gelu"))), \
         mock.patch.object(pclip.CLIPVisionConfig, "vit_l_14", staticmethod(
            lambda: pclip.CLIPVisionConfig.tiny("quick_gelu"))):
        yield


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().splitlines()[0])


def _both(files, tmp_path, argv):
    got = _run(cli.main, ["metrics", *argv, "--device", "cpu", "--out",
                          str(tmp_path / "port.csv")])
    want = _run(jcli.main, ["metrics", *argv, "--out",
                            str(tmp_path / "jax.csv")])
    assert list(got) == list(want)
    for k in want:
        if k.startswith("2way"):
            assert got[k] == want[k], k
        else:
            assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    lines = (tmp_path / "port.csv").read_text().splitlines()
    assert lines[0] == "metric,value"
    assert [ln.split(",")[0] for ln in lines[1:]] == list(got)
    assert [float(ln.split(",")[1]) for ln in lines[1:]] == list(got.values())
    return got


@pytest.mark.parametrize("layout", ["tree", "tree_seed1", "npy", "npz",
                                    "named"])
def test_metrics_cli_matches_jax(files, tmp_path, layout):
    """Every layout with the AlexNet rows; the ``tree`` case also with the
    CLIP row."""
    argv = {"tree": ["--generated", str(files / "generated")],
            "tree_seed1": ["--generated", str(files / "generated"),
                           "--gen-seed", "1"],
            "npy": ["--generated", str(files / "gen.npy")],
            "npz": ["--generated", str(files / "gen.npz")],
            "named": ["--generated", str(files / "named"), "--class-names",
                      str(files / "names.txt")]}[layout]
    argv += ["--ground-truth", str(files / "gt"), "--image-size", str(SIZE),
             "--backbone-params", str(files / "backbones.pkl")]
    if layout == "tree":
        argv += ["--clip-params", str(files / "clip.pkl")]
    with _tiny_vit_l():
        got = _both(files, tmp_path, argv)
    rows = ["pixcorr", "ssim", "2way_alexnet2", "dist_alexnet2",
            "2way_alexnet5", "dist_alexnet5"]
    assert list(got) == rows + (["2way_clip", "dist_clip"]
                                if layout == "tree" else [])


def test_metrics_cli_flat_directory_and_no_extractors(files, tmp_path):
    """A flat directory (sorted by name, a JPEG among the PNGs) on both
    sides; no backbone, so PixCorr and SSIM only."""
    got = _both(files, tmp_path, ["--generated", str(files / "gt"),
                                  "--ground-truth", str(files / "gt"),
                                  "--image-size", "20"])
    assert list(got) == ["pixcorr", "ssim"]
    assert got["pixcorr"] > 0.9999 and got["ssim"] > 0.9999


@pytest.mark.parametrize("case", ["count", "missing_dir"])
def test_metrics_cli_errors_like_jax(files, case):
    argv = {"count": ["--generated", str(files / "gen.npy"),
                      "--ground-truth", str(files / "gt2.npy")],
            "missing_dir": ["--generated", str(files / "named"),
                            "--class-names", str(files / "names_missing.txt"),
                            "--ground-truth", str(files / "gt")]}[case]
    argv += ["--image-size", str(SIZE)]
    with pytest.raises(SystemExit) as got:
        cli.main(["metrics", *argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jcli.main(["metrics", *argv])
    assert str(got.value) == str(want.value)
    assert ("differ" if case == "count" else "fig") in str(got.value)


def test_metrics_cli_needs_a_card_by_default(files):
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
         pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["metrics", "--generated", str(files / "gen.npy"),
                  "--ground-truth", str(files / "gt"), "--image-size",
                  str(SIZE)])
