"""The port's caption service, ``/v1/caption`` and the captioning commands,
fp32 on the CPU with the tiny GIT.

- ``CaptionService``: the full-width ATM-S encoder → a prior with 1024-d
  conditions → the tiny projector and GIT; a row's token ids do not depend
  on its batch (alone, in a padded chunk, across chunks), equal the stages
  chained by hand, and its prior embedding equals the reconstruction
  service's for the same (seed, row) (one ``PRIOR_DOMAIN``);
- ``/v1/caption`` through the daemon: ``{"captions": [...]}`` equal to the
  service called directly, coalesced concurrent requests, 501 on the
  unconfigured routes;
- ``cli caption --embeddings`` line-equal to the JAX CLI on the same
  pickles, with and without ``--vocab``; ``--eeg-features`` by its lines;
- ``cli train-adapter --grids`` against the JAX CLI's JSON from the same
  init (bf16 products on both sides: ≤ 2e-2 relative), each package
  reading the other's pickle; ``--images-dir`` through the tiny grid tower
  against the JAX grids (the same cache file, ≤ 1e-5);
- ``cli serve --git-params`` answering ``/v1/caption`` over HTTP, and its
  refusals.
"""

import argparse
import contextlib
import io
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from eeg_image_decode_tpu import cli as jcli
from eeg_image_decode_tpu.models import git_caption as jgit
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.config import ATMSConfig, PriorConfig
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_wordpiece_vocab,
)
from eeg_image_decode_tpu_torch.data.tokenizers import WordPieceTokenizer
from eeg_image_decode_tpu_torch.models import git_caption as pgit
from eeg_image_decode_tpu_torch.models.clip_vit import (
    CLIPVisionConfig,
    CLIPVisionTower,
)
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import (
    PRIOR_DOMAIN,
    CaptionService,
    ReconstructionService,
    _padded_chunks,
    _prior_embeddings,
    _row_keys,
)
from eeg_image_decode_tpu_torch.server import EEGDecodeServer
from eeg_image_decode_tpu_torch.train import adapters as padapters
from eeg_image_decode_tpu_torch.train.prior import PriorPipe
from eeg_image_decode_tpu_torch.utils import convert as pconvert
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_tree_from_state_dict,
)
from torch_port_case import randomize

CFG = pgit.GITConfig.tiny()
#: a small prior on the full encoder's 1024-d features, emitting 16-d
#: embeddings for the tiny projector
PRIOR = PriorConfig(embed_dim=16, cond_dim=1024, hidden_dims=(64, 32),
                    time_embed_dim=32, num_inference_steps=4)
#: a row's prior sample in another batch shape (``chip_smoke.py``'s bound)
REBATCH_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and each PyTorch process would otherwise take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _prior(cfg=PRIOR):
    pipe = PriorPipe(cfg, device="cpu")
    pipe.init(total_steps=1, seed=3)
    return pipe


def _git_tree(seed=0):
    model = jgit.GITCaptioner(jgit.GITConfig.tiny())
    shapes = jax.eval_shape(
        model.init, jax.random.key(0),
        jnp.zeros((1, CFG.num_visual_tokens, CFG.visual_dim)),
        jnp.zeros((1, 2), jnp.int32))["params"]
    return randomize(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), seed)


def _projector(seed=1):
    return pgit.PixelProjector(CFG.num_visual_tokens, PRIOR.embed_dim,
                               CFG.visual_dim).init_random(seed)


def _vocab(directory):
    return write_synthetic_wordpiece_vocab(
        str(directory), ["a red aardvark playing with an old abacus"],
        vocab_size=CFG.vocab_size, cls_id=CFG.bos_token_id,
        sep_id=CFG.eos_token_id)


def _eeg(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 250)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


class _Echo:
    """A generator that hands the prior's embeddings back as its images:
    the reconstruction service's prior stage, read out."""

    def generate(self, embeds, decode=False, row_keys=None):
        return embeds

    def decode(self, latents):
        return latents


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    model = build_encoder("atms", config=ATMSConfig(), device="cpu", seed=0)
    git = pgit.GITCaptioner(CFG).load_params(_git_tree())
    tok = WordPieceTokenizer.from_file(_vocab(tmp_path_factory.mktemp("v")))
    return CaptionService(model, _prior(), git, _projector(), tok,
                          max_batch=2, max_new_tokens=5, device="cpu")


def test_caption_rows_do_not_depend_on_their_batch(service):
    eeg, sids = _eeg(3)
    tokens = service.tokens(eeg, sids, seed=5)
    assert tokens.shape == (3, 6) and (tokens[:, 0] == CFG.bos_token_id).all()
    alone = np.concatenate([
        service.tokens(eeg[i:i + 1], sids[i:i + 1], row_seeds=[[5, i]])
        for i in range(3)])
    np.testing.assert_array_equal(alone, tokens)
    caps = service.caption(eeg, sids, seed=5)
    assert caps == [service.tokenizer.decode(r) for r in tokens]
    assert all(isinstance(c, str) for c in caps) and any(caps)

    # the stages chained by hand
    rs = np.stack([np.full(3, 5), np.arange(3)], 1)
    with torch.no_grad():
        feats, _ = service.model(torch.from_numpy(eeg),
                                 torch.from_numpy(sids))
        emb = service.prior.generate(feats.float(), row_keys=torch.from_numpy(
            _row_keys(rs, PRIOR_DOMAIN)))
        want = service.captioner.generate(service.projector(emb),
                                          max_new_tokens=5)
    np.testing.assert_array_equal(tokens, want.numpy())
    assert pgit.caption_embeddings(
        service.captioner, service.projector, emb, service.tokenizer,
        max_new_tokens=5) == caps

    # a (seed, row) samples the same embedding in the reconstruction service
    recon = ReconstructionService(service.model, service.prior, _Echo(),
                                  max_batch=2, device="cpu")
    with torch.no_grad():
        got = torch.cat([
            _prior_embeddings(service.model, service.prior, *chunk,
                              service.device, [[]])[:m]
            for chunk, m in _padded_chunks(eeg, sids, None, 5,
                                           service.max_batch)]).numpy()
    np.testing.assert_array_equal(got, recon.reconstruct(eeg, sids, seed=5))
    # the hand chain ran the three rows as one batch, the services as
    # chunks of 2: the prior's rebatch bound
    np.testing.assert_allclose(got, emb.numpy(), atol=REBATCH_TOL, rtol=0)


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_caption_route_serves_the_service(service):
    eeg, sids = _eeg(4, seed=1)
    server = EEGDecodeServer(caption=service)
    port = server.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read())["services"] == ["caption"]
        want = service.caption(eeg[:3], sids[:3], seed=5)
        got = _post(base + "/v1/caption", _npz(
            eeg=eeg[:3], subject_ids=sids[:3], seed=np.int64(5)),
            "application/octet-stream")
        assert got == {"captions": want}
        got = _post(base + "/v1/caption", json.dumps(
            {"eeg": eeg[:1].tolist(), "subject_ids": int(sids[0]),
             "seed": 5}).encode(), "application/json")
        assert got["captions"] == want[:1]

        results = {}

        def client(i):
            results[i] = _post(base + "/v1/caption", _npz(
                eeg=eeg[i:i + 2], subject_ids=sids[i:i + 2],
                seed=np.int64(i)), "application/octet-stream")["captions"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(3):
            assert results[i] == service.caption(eeg[i:i + 2], sids[i:i + 2],
                                                 seed=i)
        for route in ("/v1/retrieve", "/v1/reconstruct"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + route, _npz(eeg=eeg[:1], subject_ids=sids[:1]),
                      "application/octet-stream")
            assert e.value.code == 501
    finally:
        server.stop()


# ——— the commands ———


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.strip()][-1])


def _pickles(tmp_path):
    """The tiny GIT tree and a projector tree (16-d embeddings), as the
    JAX CLI reads them."""
    paths = (str(tmp_path / "git.pkl"), str(tmp_path / "proj.pkl"))
    for path, tree in zip(paths, (_git_tree(seed=2),
                                  pconvert.pixel_projector_tree_from_state_dict(
                                      _projector(seed=4).state_dict()))):
        with open(path, "wb") as f:
            pickle.dump(tree, f)
    return paths


def test_cli_caption_matches_the_jax_cli(tmp_path):
    git, proj = _pickles(tmp_path)
    emb = str(tmp_path / "emb.npz")
    np.savez(emb, clip_embeds=np.random.default_rng(6).normal(
        size=(3, PRIOR.embed_dim)).astype(np.float32))
    vocab = _vocab(tmp_path)
    common = ["caption", "--embeddings", emb, "--git-params", git,
              "--projector-params", proj, "--tiny", "--caption-batch", "2",
              "--max-new-tokens", "5"]
    for extra in (["--vocab", vocab], []):
        want, got = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
        with contextlib.redirect_stdout(io.StringIO()):
            jcli.main([*common, *extra, "--out", want])
        row = _run([*common, *extra, "--out", got, "--device", "cpu"])
        assert row["captions"] == 3 and row["out"] == got
        with open(want) as f, open(got) as g:
            lines = g.read()
            assert lines == f.read() and len(lines.splitlines()) == 3

    prior = _prior().save_with_config(str(tmp_path / "prior.pkl"))
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, eeg_features_test=np.random.default_rng(7).normal(
        size=(5, 1024)).astype(np.float32))
    out = str(tmp_path / "prior_caps.txt")
    _run(["caption", "--eeg-features", feats, "--prior-params", prior,
          "--git-params", git, "--projector-params", proj, "--vocab", vocab,
          "--tiny", "--caption-batch", "2", "--out", out, "--device", "cpu"])
    with open(out) as f:
        assert len(f.read().splitlines()) == 5
    with pytest.raises(SystemExit, match="--projector-params"):
        cli.main(["caption", "--embeddings", emb, "--git-params", git,
                  "--tiny", "--device", "cpu"])


#: the adapter's losses against JAX after two epochs of bf16 products on
#: both sides (XLA and PyTorch round at other points of the fused
#: elementwise work), relative
ADAPTER_CLI_TOL = 2e-2


def test_cli_train_adapter_matches_the_jax_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    n, d, t, o = 40, 16, 5, 12
    files = {}
    for split, rows in (("train", n), ("test", 12)):
        files[split] = (str(tmp_path / f"e_{split}.npz"),
                        str(tmp_path / f"g_{split}.npz"))
        np.savez(files[split][0], img_features=(rng.normal(size=(
            rows, d)) / np.sqrt(d)).astype(np.float32))
        np.savez(files[split][1], grids=rng.normal(size=(rows, t, o)).astype(
            np.float32))
    common = ["train-adapter", "--embeddings", files["train"][0], "--grids",
              files["train"][1], "--test-embeddings", files["test"][0],
              "--test-grids", files["test"][1], "--epochs", "2",
              "--batch-size", "8", "--seed", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main([*common, "--out", str(tmp_path / "jax.pkl")])
    want = json.loads(buf.getvalue().splitlines()[-1])
    init = jax.tree_util.tree_map(np.asarray, jax.jit(
        jgit.PixelProjector(num_tokens=t, out_dim=o).init)(
            jax.random.key(3), jnp.zeros((1, d)))["params"])

    def jax_init(num_tokens, in_dim, out_dim, *, seed, dtype, device):
        m = pgit.PixelProjector(num_tokens, in_dim, out_dim, dtype=dtype)
        m.load_state_dict(pconvert.pixel_projector_state_dict_from_flax(
            init), strict=True)
        return m

    monkeypatch.setattr(padapters, "init_pixel_projector", jax_init)
    got = _run([*common, "--out", str(tmp_path / "port.pkl"),
                "--device", "cpu"])
    assert got.keys() == want.keys() and got["epochs"] == 2
    for k in ("final_train_loss", "test_mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=ADAPTER_CLI_TOL)
    # each package reads the other's pickle
    with open(tmp_path / "port.pkl", "rb") as f:
        port_tree = pickle.load(f)
    jgit.PixelProjector(num_tokens=t, out_dim=o).apply(
        {"params": port_tree}, jnp.zeros((1, d)))
    pgit.PixelProjector(t, d, o).load_state_dict(
        pconvert.pixel_projector_state_dict_from_flax(
            pconvert.load_numpy_pickle(str(tmp_path / "jax.pkl"))),
        strict=True)
    with pytest.raises(SystemExit, match="counts differ"):
        cli.main(["train-adapter", "--embeddings", files["test"][0],
                  "--grids", files["train"][1], "--device", "cpu"])


def test_cli_train_adapter_encodes_grids(tmp_path):
    """``--images-dir``: the tiny grid tower's grids in the JAX cache file,
    equal to the JAX CLI's encode of the same tower and images."""
    images = tmp_path / "img"
    rng = np.random.default_rng(9)
    for i in range(3):
        (images / f"{i:05d}_thing").mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (40 + 4 * i, 36, 3), np.uint8)
                        ).save(images / f"{i:05d}_thing" / "a.png")
    vcfg = CLIPVisionConfig.tiny()
    vision = str(tmp_path / "vision.pkl")
    with open(vision, "wb") as f:
        pickle.dump(clip_tree_from_state_dict(CLIPVisionTower(
            vcfg, seed=0).state_dict(), "vision", vcfg.heads), f)
    emb = str(tmp_path / "emb.npy")
    np.save(emb, rng.normal(size=(3, 8)).astype(np.float32))
    row = _run(["train-adapter", "--embeddings", emb, "--images-dir",
                str(images), "--git-vision-params", vision, "--tiny",
                "--epochs", "1", "--batch-size", "2", "--cache-dir",
                str(tmp_path / "port"), "--out", str(tmp_path / "p.pkl"),
                "--device", "cpu"])
    assert np.isfinite(row["final_train_loss"])
    (name,) = os.listdir(tmp_path / "port")
    assert name.startswith("ViT-L-14-GIT-grid_features_train_")
    want = jcli._compute_git_grids(argparse.Namespace(
        tiny=True, git_vision_params=vision, cache_dir=str(tmp_path / "jax"),
        grid_batch=20), str(images), split="train")
    assert os.listdir(tmp_path / "jax") == [name]
    with np.load(tmp_path / "port" / name) as z:
        got = z["grids"]
    assert got.shape == want.shape == (3, 17, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cli_serve_answers_caption_over_http(tmp_path):
    git, proj = _pickles(tmp_path)
    gallery = str(tmp_path / "g.npz")
    np.savez(gallery, img_features=np.eye(4, 1024, dtype=np.float32))
    prior = _prior().save_with_config(str(tmp_path / "prior.pkl"))
    argv = ["serve", "--features", gallery, "--prior-params", prior,
            "--git-params", git, "--projector-params", proj, "--vocab",
            _vocab(tmp_path), "--tiny", "--gen-batch", "2", "--dtype",
            "float32", "--max-new-tokens", "4", "--device", "cpu"]
    server = cli.build_server(cli.build_parser().parse_args(argv))
    assert server.caption.max_batch == 2
    assert server.caption.max_new_tokens == 4
    eeg, sids = _eeg(3, seed=2)
    port = server.start(port=0)
    try:
        got = _post(f"http://127.0.0.1:{port}/v1/caption", _npz(
            eeg=eeg, subject_ids=sids, seed=np.int64(3)),
            "application/octet-stream")
    finally:
        server.stop()
    assert got == {"captions": server.caption.caption(eeg, sids, seed=3)}
    for drop, match in (("--prior-params", "needs --prior-params"),
                        ("--vocab", "--vocab")):
        i = argv.index(drop)
        with pytest.raises(SystemExit, match=match):
            cli.build_server(cli.build_parser().parse_args(
                argv[:i] + argv[i + 2:]))
