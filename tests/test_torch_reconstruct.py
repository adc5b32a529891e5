"""The port's reconstruction service, its HTTP route and the generation
commands, fp32 on the CPU with the tiny generator.

- ``serve.py::_row_keys`` is a pure function of (seed, row, domain);
- ``ReconstructionService``: the full-width ATM-S encoder → a prior with
  1024-d conditions → the tiny generator; a row's image does not depend on
  its batch (alone, in a padded chunk, across chunks: ≤ 2/255, and here
  bit-equal), equals the stages chained by hand, finite in [0, 1];
- ``/v1/reconstruct`` through the daemon: the JAX wire format (an ``.npz``
  of ``images``), coalesced concurrent requests, 501 on the unconfigured
  routes;
- ``cli latents`` against the JAX CLI on the same VAE pickle and images
  (deterministic: the latents ≤ 1e-4 and the same cache name);
- ``cli generate`` (``--class-names``/``--sub``, ``--init-latents``, the
  text encoder and ``--captions-file``), ``cli serve --prior-params
  --generator-params`` and ``cli train-lowlevel --preview-dir`` by their
  properties: the port's draws come from PyTorch, not from JAX's threefry.
"""

import contextlib
import io
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.config import ATMSConfig, PriorConfig
from eeg_image_decode_tpu_torch.data.synthetic import (
    write_synthetic_clip_vocab,
    write_synthetic_things_tree,
)
from eeg_image_decode_tpu_torch.gen.sdxl import (
    Generator4Embeds,
    GeneratorConfig,
)
from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig
from eeg_image_decode_tpu_torch.models.clip_vit import CLIPTextTower
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import (
    ReconstructionService,
    _row_keys,
)
from eeg_image_decode_tpu_torch.server import EEGDecodeServer
from eeg_image_decode_tpu_torch.train.prior import PriorPipe
from eeg_image_decode_tpu_torch.utils.convert import flax_from_params
from eeg_image_decode_tpu_torch.utils.convert_clip import (
    clip_tree_from_state_dict,
)

#: a small prior on the full encoder's 1024-d features, emitting the tiny
#: generator's 64-d image embeddings
PRIOR = PriorConfig(embed_dim=64, cond_dim=1024, hidden_dims=(64, 32),
                    time_embed_dim=32, num_inference_steps=4)
#: a row alone against the same row in another batch (the chip's bound)
BATCH_TOL = 2 / 255


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


def _generator(seed=1):
    gen = Generator4Embeds(GeneratorConfig.tiny(), dtype=torch.float32,
                           device="cpu")
    gen.init_random(seed=seed)
    return gen


@pytest.fixture(scope="module")
def service():
    model = build_encoder("atms", config=ATMSConfig(), device="cpu", seed=0)
    return ReconstructionService(model, _prior(), _generator(), max_batch=2,
                                 device="cpu")


def _eeg(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 63, 250)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_row_keys_are_a_pure_function_of_seed_row_and_domain():
    pairs = np.asarray([[5, 0], [5, 1], [6, 0], [5, 0]], np.uint32)
    k0, k1 = _row_keys(pairs, 0), _row_keys(pairs, 1)
    assert k0.dtype == np.int64 and k0.shape == (4,)
    np.testing.assert_array_equal(k0, _row_keys(pairs.copy(), 0))
    assert k0[0] == k0[3] and len(set(k0[:3])) == 3
    assert not np.any(k0 == k1)


def test_reconstruction_rows_do_not_depend_on_their_batch(service):
    eeg, sids = _eeg(3)
    out = service.reconstruct(eeg, sids, seed=5)
    assert out.shape == (3, 16, 16, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    assert out.std() > 0
    alone = np.concatenate([
        service.reconstruct(eeg[i:i + 1], sids[i:i + 1],
                            row_seeds=[[5, i]]) for i in range(3)])
    assert np.abs(alone - out).max() <= BATCH_TOL
    np.testing.assert_array_equal(alone, out)  # fp32 on the CPU: bit-equal
    # another seed gives other images
    assert np.abs(service.reconstruct(eeg[:1], sids[:1], seed=6)
                  - out[:1]).max() > 1e-3

    # the stages chained by hand on the first chunk
    with torch.no_grad():
        feats, _ = service.model(torch.from_numpy(eeg[:2]),
                                 torch.from_numpy(sids[:2]))
        pairs = np.asarray([[5, 0], [5, 1]], np.uint32)
        emb = service.prior.generate(feats.float(), row_keys=torch.from_numpy(
            _row_keys(pairs, 0)))
        imgs = service.generator.generate(
            emb, row_keys=torch.from_numpy(_row_keys(pairs, 1)))
    np.testing.assert_array_equal(imgs.numpy(), out[:2])


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _images(body):
    with np.load(io.BytesIO(body)) as z:
        assert z.files == ["images"]
        return z["images"]


def test_reconstruct_route_serves_the_service(service):
    eeg, sids = _eeg(4, seed=1)
    server = EEGDecodeServer(reconstruction=service)
    port = server.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read())["services"] == ["reconstruction"]
        got = _images(_post(base + "/v1/reconstruct",
                            _npz(eeg=eeg[:3], subject_ids=sids[:3],
                                 seed=np.int64(5)),
                            "application/octet-stream"))
        want = service.reconstruct(eeg[:3], sids[:3], seed=5)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        got = _images(_post(base + "/v1/reconstruct", json.dumps(
            {"eeg": eeg[:1].tolist(), "subject_ids": int(sids[0]),
             "seed": 5}).encode(), "application/json"))
        np.testing.assert_array_equal(got, want[:1])

        # concurrent clients coalesce and still get their own rows
        results = {}

        def client(i):
            results[i] = _images(_post(
                base + "/v1/reconstruct",
                _npz(eeg=eeg[i:i + 2], subject_ids=sids[i:i + 2],
                     seed=np.int64(i)), "application/octet-stream"))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(3):
            alone = service.reconstruct(eeg[i:i + 2], sids[i:i + 2], seed=i)
            assert np.abs(results[i] - alone).max() <= BATCH_TOL

        for route, want_code in (("/v1/caption", 501), ("/v1/retrieve", 501),
                                 ("/v1/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + route, _npz(eeg=eeg[:1], subject_ids=sids[:1]),
                      "application/octet-stream")
            assert e.value.code == want_code
    finally:
        server.stop()


# ——— the commands ———


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.strip()][-1])


def _vae_pickle(path, seed=0):
    """A tiny VAE as the JAX VAE's param tree of numpy arrays."""
    torch.manual_seed(seed)
    vae = VAE(VAEConfig.tiny())
    tree = flax_from_params({f"vae.{k}": v
                             for k, v in vae.state_dict().items()})["vae"]
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return str(path)


def _write_images(root, n):
    rng = np.random.default_rng(12)
    paths = []
    for i in range(n):
        d = os.path.join(root, f"{i:05d}_thing{i}")
        os.makedirs(d, exist_ok=True)
        size = (40 + 7 * i, 32 + 5 * i)
        Image.fromarray(rng.integers(0, 256, (*size[::-1], 3), np.uint8)
                        ).save(os.path.join(d, "a.png"))
        paths.append(os.path.join(d, "a.png"))
    return paths


def test_cli_latents_matches_the_jax_cli(tmp_path):
    from eeg_image_decode_tpu import cli as jcli

    vae = _vae_pickle(tmp_path / "vae.pkl")
    images = str(tmp_path / "img")
    _write_images(images, 3)
    args = ["latents", "--images-dir", images, "--vae-params", vae,
            "--tiny", "--batch-size", "2", "--split", "test"]
    row = _run([*args, "--cache-dir", str(tmp_path / "port"),
                "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        jcli.main([*args, "--cache-dir", str(tmp_path / "jax")])
    port_files = os.listdir(tmp_path / "port")
    assert port_files == os.listdir(tmp_path / "jax")
    assert port_files[0].startswith("sdxl-vae-16_features_test_")
    assert row["latent_shape"] == [3, 8, 8, 4]
    assert row["cache"] == str(tmp_path / "port" / port_files[0])
    with np.load(tmp_path / "port" / port_files[0]) as z:
        got = z["latents"]
    with np.load(tmp_path / "jax" / port_files[0]) as z:
        want = z["latents"]
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1)


def _write_prior(path, cfg):
    return _prior(cfg).save_with_config(str(path))


def test_cli_generate_writes_the_reference_tree(tmp_path):
    n = 3
    rng = np.random.default_rng(13)
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, eeg_features_test=rng.normal(size=(n, 64)).astype(
        np.float32))
    prior = _write_prior(tmp_path / "prior.pkl", PriorConfig.tiny())
    names = tmp_path / "names.txt"
    names.write_text("aardvark\nabacus\nacorn\n")
    out = str(tmp_path / "gen")
    common = ["generate", "--eeg-features", feats, "--prior-params", prior,
              "--tiny", "--device", "cpu", "--seeds", "2", "--gen-batch",
              "2"]
    row = _run([*common, "--output-dir", out, "--class-names", str(names),
                "--sub", "sub-08"])
    assert row["images"] == 6 and row["resolution"] == 16
    for name in ("aardvark", "abacus", "acorn"):
        assert sorted(os.listdir(os.path.join(out, "sub-08", name))) == [
            "0.png", "1.png"]
    first = np.asarray(Image.open(os.path.join(out, "sub-08", "acorn",
                                               "0.png")))
    assert first.shape == (16, 16, 3)
    second = np.asarray(Image.open(os.path.join(out, "sub-08", "acorn",
                                                "1.png")))
    assert np.abs(first.astype(int) - second).max() > 0  # seeds differ

    # img2img from per-class latents (NCHW), and the text path with captions
    lat = str(tmp_path / "lat.npz")
    np.savez(lat, latents=rng.normal(size=(n, 4, 8, 8)).astype(np.float32))
    vocab, _ = write_synthetic_clip_vocab(
        str(tmp_path / "tok"), ["a photo of an acorn"], vocab_size=600)
    te = {}
    for name, width, emb, act in (("te1", 32, 32, "quick_gelu"),
                                  ("te2", 32, 64, "gelu")):
        from eeg_image_decode_tpu_torch.models.clip_vit import CLIPTextConfig

        tower = CLIPTextTower(CLIPTextConfig(
            vocab_size=600, context_length=12, width=width, layers=2,
            heads=2, embed_dim=emb, act=act), seed=len(te))
        te[name] = clip_tree_from_state_dict(tower.state_dict(), "text", 2)
    with open(tmp_path / "te.pkl", "wb") as f:
        pickle.dump(te, f)
    caps = tmp_path / "caps.txt"
    caps.write_text("a photo of an acorn\n\nan abacus\n")
    out2 = str(tmp_path / "gen2")
    row = _run([*common, "--output-dir", out2, "--init-latents", lat,
                "--img2img-strength", "0.5", "--text-encoder-params",
                str(tmp_path / "te.pkl"), "--tokenizer-dir",
                os.path.dirname(vocab), "--captions-file", str(caps)])
    other = np.asarray(Image.open(os.path.join(out2, "class_0002", "0.png")))
    assert row["images"] == 6 and other.shape == (16, 16, 3)
    assert np.abs(other.astype(int) - first).max() > 0
    with pytest.raises(SystemExit, match="--init-latents rows"):
        np.savez(lat, latents=np.zeros((2, 4, 8, 8), np.float32))
        cli.main([*common, "--output-dir", out2, "--init-latents", lat])

    # --resolution sets the latent size (the tiny VAE upsamples 2×)
    out3 = str(tmp_path / "gen3")
    row = _run([*common, "--seeds", "1", "--output-dir", out3,
                "--resolution", "32"])
    assert row["resolution"] == 32 and np.asarray(Image.open(os.path.join(
        out3, "class_0000", "0.png"))).shape == (32, 32, 3)
    with pytest.raises(SystemExit, match="multiple of the VAE factor"):
        cli.main([*common, "--output-dir", out3, "--resolution", "33"])


def test_cli_serve_builds_the_reconstruction_service(tmp_path):
    """``serve --prior-params --generator-params --tiny``: the service's
    images equal a service built in process from the same prior and
    generator (the generator through the JAX pickle layout)."""
    gallery = str(tmp_path / "g.npz")
    np.savez(gallery, img_features=np.eye(4, 1024, dtype=np.float32))
    prior = _write_prior(tmp_path / "prior.pkl", PRIOR)
    gen = _generator(seed=4)
    with open(tmp_path / "gen.pkl", "wb") as f:
        pickle.dump(flax_from_params(gen.net.state_dict()), f)
    args = cli.build_parser().parse_args([
        "serve", "--features", gallery, "--prior-params", prior,
        "--generator-params", str(tmp_path / "gen.pkl"), "--tiny",
        "--gen-batch", "2", "--dtype", "float32", "--device", "cpu"])
    retrieval = cli.build_retrieval(args)
    svc = cli.build_reconstruction(args, retrieval.model)
    eeg, sids = _eeg(1, seed=2)
    got = svc.reconstruct(eeg, sids, seed=3)
    pipe = PriorPipe.from_checkpoint(prior, device="cpu")
    want = ReconstructionService(retrieval.model, pipe, gen, max_batch=2,
                                 device="cpu").reconstruct(eeg, sids, seed=3)
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(got, want)


def test_cli_train_lowlevel_writes_previews(tmp_path):
    root = str(tmp_path / "things")
    write_synthetic_things_tree(root, ("sub-01",), n_classes=2,
                                n_test_classes=1, train_reps=1, test_reps=1,
                                seed=41)
    latents = str(tmp_path / "latents.npz")
    np.savez(latents, latents=(0.1 * np.random.default_rng(42).normal(
        size=(20, 4, 64, 64))).astype(np.float32))
    previews = tmp_path / "previews"
    row = _run(["train-lowlevel", "--data-path", root, "--subjects",
                "sub-01", "--latents", latents, "--device", "cpu",
                "--batch-size", "10", "--tiny", "--epochs", "3",
                "--output-dir", str(tmp_path / "ll"), "--preview-dir",
                str(previews), "--vae-params",
                _vae_pickle(tmp_path / "vae.pkl"), "--preview-every", "2"])
    assert row["epoch"] == 2
    # every 2nd epoch (epoch index 1) and after the last (index 2)
    assert sorted(os.listdir(previews)) == ["epoch_0001", "epoch_0002"]
    files = sorted(os.listdir(previews / "epoch_0002"))
    assert files == ["00.png", "01.png", "02.png", "03.png"]
    img = np.asarray(Image.open(previews / "epoch_0002" / "00.png"))
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8
