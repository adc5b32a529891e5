"""``cli features`` and ``cli export-checkpoint`` of the port against the
JAX package, on the CPU: the same feature cache (file name, features
within 1e-5) for one image tree and one params pickle; the reference
``.pth`` layout equal key for key and array for array to the JAX export of
the same weights, and back (the same outputs); the image listing and the
loader's ``classes`` / ``pictures`` subsets; ``summary.png``."""

import contextlib
import io
import json
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from eeg_image_decode_tpu import cli as jax_cli
from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.data import things_eeg as jax_things
from eeg_image_decode_tpu.data.features import load_features
from eeg_image_decode_tpu.data.tokenizers import bytes_to_unicode
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.models.clip_vit import (
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
)
from eeg_image_decode_tpu.utils.convert import (
    convert_atms_state_dict as jax_convert_atms,
)
from eeg_image_decode_tpu.utils.convert import export_atms_state_dict
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.data import things_eeg as port_things
from eeg_image_decode_tpu_torch.data.synthetic import (
    make_synthetic_retrieval_data,
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.train.contrastive import (
    ContrastiveTrainer,
    create_train_state,
)
from eeg_image_decode_tpu_torch.utils.convert import (
    convert_atms_state_dict,
    params_from_flax,
    reference_atms_config,
)
from eeg_image_decode_tpu_torch.utils.plotting import plot_training_summary
from torch_port_case import SMALL, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Three class dirs (one without an underscore) of two 24 × 24 JPEGs,
    the tiny tokenizer files and a params pickle of the JAX tiny towers
    (numpy leaves)."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(0)
    img_root = root / "training_images"
    for name in ("00001_aardvark", "00002_abacus", "oddball"):
        d = img_root / name
        d.mkdir(parents=True)
        for j in range(2):
            arr = rng.integers(0, 255, size=(24, 30, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{j}.jpg")
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")
    vcfg = CLIPVisionConfig.tiny()
    tcfg = CLIPTextConfig(vocab_size=len(vocab), context_length=16, width=32,
                          layers=2, heads=2, embed_dim=vcfg.embed_dim)
    vp = CLIPVisionTower(vcfg).init(jax.random.key(0),
                                    jnp.zeros((1, 32, 32, 3)))["params"]
    tp = CLIPTextTower(tcfg).init(jax.random.key(1),
                                  jnp.zeros((1, 16), jnp.int32))["params"]
    with open(root / "clip.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray,
                                           {"vision": vp, "text": tp}), f)
    return root


def _features_argv(root, cache, *extra):
    return ["features", "--images-dir", str(root / "training_images"),
            "--clip-params", str(root / "clip.pkl"),
            "--vocab", str(root / "vocab.json"),
            "--merges", str(root / "merges.txt"), "--cache-dir", str(cache),
            "--split", "test", "--tiny", *extra]


def test_cli_features_matches_jax(image_tree, tmp_path):
    """The port's ``cli features --tiny --device cpu`` and the JAX
    ``cli features --tiny``: the same cache file name and line, features
    within 1e-5 (the JAX side pads its last batch of 4; the port does
    not). ``--raw`` keys its own file, the JAX one's."""
    want = json.loads(_run(jax_cli.main, _features_argv(
        image_tree, tmp_path / "jax", "--batch-size", "4")).splitlines()[-1])
    got = json.loads(_run(cli.main, _features_argv(
        image_tree, tmp_path / "port", "--batch-size", "4", "--device",
        "cpu")).splitlines()[-1])
    assert {**got, "cache": None} == {**want, "cache": None}
    assert got["n_images"] == 6 and got["n_classes"] == 3
    assert (got["cache"].rsplit("/", 1)[-1]
            == want["cache"].rsplit("/", 1)[-1])
    g, w = load_features(got["cache"]), load_features(want["cache"])
    assert set(g) == set(w) == {"img_features", "text_features"}
    for k in w:
        assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(g["img_features"], axis=-1),
                               1.0, atol=1e-5)

    raw = json.loads(_run(cli.main, _features_argv(
        image_tree, tmp_path / "port", "--raw", "--device",
        "cpu")).splitlines()[-1])
    assert raw["cache"] != got["cache"]
    assert not np.allclose(
        np.linalg.norm(load_features(raw["cache"])["img_features"], axis=-1),
        1.0)


def test_encode_grids_matches_jax(image_tree):
    """``CLIPFeatureEncoder.encode_grids`` against the JAX
    ``FlaxCLIPFeatureEncoder.encode_grids``: the (N, 1 + grid², width)
    token grids within 1e-5, the last batch unpadded."""
    from eeg_image_decode_tpu.data.features import FlaxCLIPFeatureEncoder
    from eeg_image_decode_tpu_torch.data.features import CLIPFeatureEncoder
    from eeg_image_decode_tpu_torch.models import clip_vit as pclip
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_state_dict_from_flax,
        load_clip_params,
    )

    params = load_clip_params(str(image_tree / "clip.pkl"))
    paths, _ = jax_things.things_images_and_prompts(
        str(image_tree / "training_images"))
    want = FlaxCLIPFeatureEncoder(
        CLIPVisionTower(CLIPVisionConfig.tiny()), params["vision"]
    ).encode_grids(paths, batch_size=4)
    tower = pclip.CLIPVisionTower(pclip.CLIPVisionConfig.tiny())
    tower.load_state_dict(clip_state_dict_from_flax(params["vision"],
                                                    "vision"))
    enc = CLIPFeatureEncoder(tower, device="cpu")
    got = enc.encode_grids(paths, batch_size=4)
    assert got.shape == want.shape == (6, 17, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert enc.stats["images"] == 6 and len(enc.stats["decode_s"]) == 2


def test_cli_features_refuses_bad_params(image_tree, tmp_path):
    bad = tmp_path / "jax_leaves.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"vision": {"proj": jnp.ones((2, 2))}, "text": {}}, f)
    argv = _features_argv(image_tree, tmp_path / "c", "--device", "cpu")
    with pytest.raises(SystemExit, match="jax.Array"):
        cli.main([*argv[:4], str(bad), *argv[5:]])
    wrong = tmp_path / "wrong.pkl"
    wrong.write_bytes(pickle.dumps({"vision_only": 1}))
    with pytest.raises(SystemExit, match="--clip-params must be"):
        cli.main([*argv[:4], str(wrong), *argv[5:]])


def test_image_listing_matches_jax(image_tree, tmp_path):
    root = str(image_tree / "training_images")
    assert (port_things.things_images_and_prompts(root)
            == jax_things.things_images_and_prompts(root))
    assert (port_things.list_image_classes(root)
            == jax_things.list_image_classes(root))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no class directories"):
        port_things.things_images_and_prompts(str(tmp_path / "empty"))
    (tmp_path / "empty" / "00001_x").mkdir()
    with pytest.raises(ValueError, match="no images"):
        port_things.things_images_and_prompts(str(tmp_path / "empty"))


def _jax_variables(joint: bool, seed: int) -> dict:
    model = jax_build_encoder("atms",
                              config=JaxATMSConfig(joint_train=joint))
    eeg, sids = jnp.zeros((2, 63, 250)), jnp.zeros((2,), jnp.int32)
    variables = jax.jit(lambda x, s: model.init(
        jax.random.key(0), x, s, deterministic=True))(eeg, sids)
    return randomize(variables, seed)


def _port_run(tmp_path, variables, joint: bool) -> str:
    """A run directory holding the port model of ``variables`` as a
    train-retrieval checkpoint (step 3)."""
    model = build_encoder("atms", config=ATMSConfig(joint_train=joint),
                          device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    run = tmp_path / "run"
    Checkpointer(str(run / "ckpt")).save(
        3, create_train_state(model, ContrastiveTrainConfig()))
    return str(run)


@pytest.mark.parametrize("joint", [False, True])
def test_export_checkpoint_matches_jax_export(tmp_path, joint):
    """``cli export-checkpoint`` of a port run against the JAX
    ``export_atms_state_dict`` of the same variables: equal keys, dtypes
    and arrays, exactly; 2 or 10 ``subject_wise_linear`` entries."""
    variables = _jax_variables(joint, seed=11)
    run = _port_run(tmp_path, variables, joint)
    out = tmp_path / "atms.pth"
    log = _run(cli.main, ["export-checkpoint", "--run-dir", run, "--out",
                          str(out), "--device", "cpu",
                          *(["--joint"] if joint else [])])
    got = torch.load(out, weights_only=True)
    want = export_atms_state_dict(variables, num_subjects=10 if joint else 2)
    assert f"({len(want)} tensors)" in log
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, w, err_msg=k)
    n_swl = len({k.split(".")[1] for k in got
                 if k.startswith("subject_wise_linear.")})
    assert n_swl == (10 if joint else 2)


def test_export_checkpoint_errors(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoints"):
        cli.main(["export-checkpoint", "--run-dir", str(tmp_path / "empty"),
                  "--out", str(tmp_path / "x.pth"), "--device", "cpu"])
    run = _port_run(tmp_path, _jax_variables(False, seed=3), False)
    with pytest.raises(SystemExit, match="step 7 not found"):
        cli.main(["export-checkpoint", "--run-dir", run, "--out",
                  str(tmp_path / "x.pth"), "--step", "7", "--device", "cpu"])
    with pytest.raises(SystemExit, match="could not restore"):
        cli.main(["export-checkpoint", "--run-dir", run, "--out",
                  str(tmp_path / "x.pth"), "--joint", "--device", "cpu"])


def test_import_round_trip_same_outputs(tmp_path):
    """export → ``convert_atms_state_dict`` gives back the same state_dict
    and the same outputs; on a reference-style checkpoint with non-zero
    conv-before-BatchNorm biases the port's import equals the JAX import
    (the biases folded into the BatchNorm means), tensor for tensor."""
    variables = _jax_variables(False, seed=5)
    run = _port_run(tmp_path, variables, False)
    out = tmp_path / "atms.pth"
    _run(cli.main, ["export-checkpoint", "--run-dir", run, "--out", str(out),
                    "--device", "cpu"])
    ref_sd = torch.load(out, weights_only=True)
    back = convert_atms_state_dict(ref_sd)
    want = params_from_flax(variables)
    assert set(back) == set(want)
    for k in want:
        assert torch.equal(back[k], want[k]), k

    rng = np.random.default_rng(9)
    for name in ("enc_eeg.0.tsconv.0.bias", "enc_eeg.0.tsconv.4.bias"):
        ref_sd[name] = torch.from_numpy(
            rng.normal(size=ref_sd[name].shape).astype(np.float32))
    port = convert_atms_state_dict(ref_sd)
    via_jax = params_from_flax(jax_convert_atms(
        {k: v.numpy() for k, v in ref_sd.items()}, fused_tsconv=True))
    assert set(port) == set(via_jax)
    for k in via_jax:
        torch.testing.assert_close(port[k], via_jax[k], rtol=0, atol=0,
                                   msg=k)

    cfg = reference_atms_config()
    assert cfg.exact_gelu
    a = build_encoder("atms", config=cfg, device="cpu").eval()
    b = build_encoder("atms", config=cfg, device="cpu").eval()
    a.load_state_dict(want, strict=True)
    b.load_state_dict(back, strict=True)
    eeg = torch.from_numpy(rng.normal(size=(4, 63, 250)).astype(np.float32))
    sids = torch.zeros(4, dtype=torch.int64)
    with torch.no_grad():
        torch.testing.assert_close(b(eeg, sids), a(eeg, sids), rtol=0, atol=0)


def test_checkpoint_tree_is_the_same_under_both_tsconv_layouts():
    """Why ``export-checkpoint`` needs no loop over ``fused_tsconv``: the
    port's state_dict has the same keys and shapes either way."""
    trees = [{k: tuple(v.shape) for k, v in build_encoder(
        "atms", config=ATMSConfig(fused_tsconv=f), device="cpu")
        .state_dict().items()} for f in (False, True)]
    assert trees[0] == trees[1]


@pytest.mark.parametrize("case", [
    dict(train=True, classes=[3, 0]),
    dict(train=True, classes=[3, 0, 3], pictures=[9, 1, 2]),
    dict(train=False, classes=[4, 1, 4]),
    dict(train=False, classes=[2], average_test_reps=False),
    dict(train=True, val_size=0.1),
])
def test_subject_subsets_match_jax(tmp_path_factory, case):
    root = tmp_path_factory.getbasetemp() / "subsets"
    if not root.exists():
        write_synthetic_things_tree(str(root), ("sub-01",), n_classes=5,
                                    n_test_classes=6, train_reps=2,
                                    test_reps=3, seed=4)
    got = port_things.load_things_eeg_subject(str(root), "sub-01", **case)
    want = jax_things.load_things_eeg_subject(str(root), "sub-01", **case)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case,match", [
    (dict(train=True, pictures=[1]), "requires classes"),
    (dict(train=False, classes=[1], pictures=[1]), "requires classes"),
    (dict(train=True, classes=[1, 2], pictures=[1]), "pair up"),
])
def test_subject_subset_errors(tmp_path, case, match):
    write_synthetic_things_tree(str(tmp_path), ("sub-01",), n_classes=3,
                                n_test_classes=2, train_reps=1, test_reps=1)
    with pytest.raises(ValueError, match=match):
        port_things.load_things_eeg_subject(str(tmp_path), "sub-01", **case)


def test_fit_writes_summary_png(tmp_path, monkeypatch):
    """``fit()`` draws ``summary.png`` into its output directory. The plot
    is best-effort: where matplotlib fails (here: a stand-in ``IPython``
    module without ``version_info``, which a test that imports the
    reference source leaves in ``sys.modules``), the run still ends and
    warns."""
    ipython = sys.modules.get("IPython")
    if ipython is not None and not hasattr(ipython, "version_info"):
        monkeypatch.delitem(sys.modules, "IPython")  # a stand-in: drop it
    train, test = make_synthetic_retrieval_data(
        n_classes=6, images_per_class=2, train_reps=2,
        n_channels=SMALL["n_channels"], n_timepoints=SMALL["seq_len"],
        clip_dim=SMALL["proj_dim"], seed=2, device="cpu")
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu")
    trainer = ContrastiveTrainer(
        model, ContrastiveTrainConfig(batch_size=8, eval_ks=(2, 6)), train,
        test, device="cpu", output_dir=str(tmp_path))
    trainer.fit(1, log_fn=None)
    assert (tmp_path / "summary.png").stat().st_size > 1000
    out = plot_training_summary(
        [{"epoch": i, "loss": 1.0 / (i + 1), "top1_k200": 0.05 * i}
         for i in range(4)], str(tmp_path / "direct.png"))
    assert out == str(tmp_path / "direct.png")
    assert (tmp_path / "direct.png").stat().st_size > 1000

    (tmp_path / "summary.png").unlink()
    monkeypatch.setitem(sys.modules, "IPython", types.ModuleType("IPython"))
    monkeypatch.setattr("matplotlib.backend_bases.FigureCanvasBase."
                        "_fix_ipython_backend2gui",
                        classmethod(lambda cls: sys.modules["IPython"]
                                    .version_info))
    with pytest.warns(UserWarning, match="summary.png not written"):
        history = trainer.fit(1, log_fn=None)
    assert len(history) == 2 and not (tmp_path / "summary.png").exists()

