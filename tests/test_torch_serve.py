"""The port's retrieval service, HTTP daemon and CLI against the JAX
service, on the CPU.

Same weights (JAX variables redrawn from a numpy seed, carried over by
``params_from_flax``), same EEG rows and subject ids. The service must give
the JAX service's top-k indices exactly — the inputs are drawn so that no
two gallery scores of a row are within the fp32 noise — including the
out-of-range subject-id quirk (one id ≥ num_subjects switches the whole
chunk to the shared token), chunking over buckets and k > k_cap. Scores:
fp32, JAX at 'highest' matmul precision, rtol 1e-3 (the model's tolerance,
tests/test_torch_atms.py).
"""

import argparse
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_image_decode_tpu.core.config import ATMSConfig as JaxATMSConfig
from eeg_image_decode_tpu.models import build_encoder as jax_build_encoder
from eeg_image_decode_tpu.serve import RetrievalService as JaxRetrievalService
from eeg_image_decode_tpu_torch import cli
from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import RetrievalService
from eeg_image_decode_tpu_torch.server import EEGDecodeServer
from eeg_image_decode_tpu_torch.utils.convert import (
    params_from_flax,
    save_flat_npz,
)
from torch_port_case import SMALL, randomize
from torch_port_case import two_threads  # noqa: F401 (autouse)


def _gallery(rng, n, d):
    g = rng.normal(size=(n, d)).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def small():
    """(JAX model, variables, port model, gallery, eeg) at SMALL width."""
    rng = np.random.default_rng(21)
    eeg = rng.normal(size=(11, 8, 100)).astype(np.float32)
    jax_model = jax_build_encoder("atms", config=JaxATMSConfig(**SMALL))
    variables = randomize(jax_model.init(
        jax.random.key(0), jnp.asarray(eeg[:2]), jnp.zeros(2, jnp.int32),
        deterministic=True), 3)
    model = build_encoder("atms", config=ATMSConfig(**SMALL), device="cpu")
    model.load_state_dict(params_from_flax(variables), strict=True)
    return jax_model, variables, model, _gallery(rng, 12, 16), eeg


@pytest.mark.parametrize("k", [3, 9], ids=["k_le_cap", "k_gt_cap"])
def test_top_k_matches_jax_service(small, k):
    jax_model, variables, model, gallery, eeg = small
    # rows 0-7 ride one chunk, rows 8-10 the next; id 5 ≥ num_subjects (3)
    # puts the second chunk on the shared token
    sids = np.asarray([0, 1, 2, 1, 0, 2, 1, 0, 1, 5, 2], np.int32)
    jax_svc = JaxRetrievalService(jax_model, variables, gallery, max_batch=8,
                                  k_cap=4)
    svc = RetrievalService(model, gallery, max_batch=8, k_cap=4, device="cpu")
    want_s, want_i = jax_svc.top_k(eeg, sids, k=k)
    got_s, got_i = svc.top_k(eeg, sids, k=k)
    assert got_i.dtype == np.int32 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-3, atol=1e-3)


def test_float16_wire_format(small):
    """``transfer_dtype="float16"`` sends the EEG rows at half width: the
    answers are the float32 service's up to the input rounding (2^-11
    relative), well inside the model tolerance."""
    _, _, model, gallery, eeg = small
    want_s, _ = RetrievalService(model, gallery, max_batch=8,
                                 device="cpu").top_k(eeg, 1, k=3)
    got_s, got_i = RetrievalService(model, gallery, max_batch=8,
                                    transfer_dtype="float16",
                                    device="cpu").top_k(eeg, 1, k=3)
    assert got_i.shape == (11, 3)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-2, atol=1e-2)


def test_request_validation(small):
    _, _, model, gallery, eeg = small
    svc = RetrievalService(model, gallery, max_batch=8, device="cpu")
    with pytest.raises(ValueError, match="zero EEG rows"):
        svc.top_k(eeg[:0], 0)
    with pytest.raises(ValueError, match="does not match"):
        svc.top_k(eeg[:3], [0, 1])
    with pytest.raises(ValueError, match="k must be"):
        svc.top_k(eeg[:3], 0, k=13)


@pytest.mark.parametrize("ks", [(), (3,), (5,), (9, 5, 12)],
                         ids=["none", "k_le_cap", "k_gt_cap", "mixed"])
def test_warmup_runs_the_full_ranking_path_only_when_asked(small, ks):
    """``warmup(eeg_shape, ks)`` as JAX's: every bucket once through the
    top-``k_cap`` path, and once more through the full ranking (k = the
    gallery size on the device) only when ``ks`` holds a k above k_cap;
    the answers after it are the cold service's."""
    _, _, model, gallery, eeg = small
    sids = np.asarray([0, 1, 2, 1, 0, 2, 1, 0, 1, 2, 2], np.int32)
    cold = RetrievalService(model, gallery, max_batch=32, k_cap=4,
                            device="cpu")
    want = {k: cold.top_k(eeg, sids, k=k) for k in (3, 9)}
    svc = RetrievalService(model, gallery, max_batch=32, k_cap=4,
                           device="cpu")
    calls = []
    query = svc._query

    def spy(x, s, k):
        calls.append((x.shape[0], k))
        return query(x, s, k)

    svc._query = spy
    svc.warmup((8, 100), ks=ks)
    full = [len(gallery)] if any(k > svc.k_cap for k in ks) else []
    assert calls == [(b, k) for b in svc.buckets for k in (svc.k_cap, *full)]
    for k, (want_s, want_i) in want.items():
        got_s, got_i = svc.top_k(eeg, sids, k=k)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)


def _post(url, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_server_answers_as_the_service(small):
    _, _, model, gallery, eeg = small
    svc = RetrievalService(model, gallery, max_batch=8, device="cpu")
    server = EEGDecodeServer(retrieval=svc)
    port = server.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True,
                                            "services": ["retrieval"]}
        sids = np.asarray([1, 0, 2, 1, 0], np.int32)
        code, out = _post(base + "/v1/retrieve",
                          _npz(eeg=eeg[:5], subject_ids=sids, k=np.int64(4)),
                          "application/octet-stream")
        want_s, want_i = svc.top_k(eeg[:5], sids, k=4)
        assert code == 200
        np.testing.assert_array_equal(out["indices"], want_i)
        np.testing.assert_allclose(out["scores"], want_s, rtol=1e-6)
        code, out = _post(base + "/v1/retrieve", json.dumps(
            {"eeg": eeg[:2].tolist(), "subject_ids": 2, "k": 3}).encode(),
            "application/json")
        assert code == 200
        np.testing.assert_array_equal(out["indices"],
                                      svc.top_k(eeg[:2], 2, k=3)[1])

        # concurrent clients coalesce and still get their own rows
        results = {}

        def client(i):
            results[i] = _post(base + "/v1/retrieve",
                               _npz(eeg=eeg[i:i + 2], subject_ids=np.int32(1)),
                               "application/octet-stream")[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(4):
            np.testing.assert_array_equal(
                results[i]["indices"], svc.top_k(eeg[i:i + 2], 1, k=5)[1])

        for route, body, want in [
            ("/v1/reconstruct", _npz(eeg=eeg[:1], subject_ids=np.int32(0)), 501),
            ("/v1/nope", b"{}", 404),
            ("/v1/retrieve", json.dumps({"eeg": [[1.0]],
                                         "subject_ids": 0}).encode(), 400),
        ]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + route, body, "application/octet-stream"
                      if route == "/v1/reconstruct" else "application/json")
            assert e.value.code == want
    finally:
        server.stop()


def test_coalescer_bounds_batches_by_max_rows():
    """``_Coalescer(max_rows=)`` as JAX's (``tests/test_server.py::
    test_coalescer_batches_and_demuxes``): a backlog under ``max_rows=64``
    merges into fewer dispatches and every request gets its own rows; at
    ``max_rows=4`` a request of 9 rows rides alone and each dispatch of a
    backlog holds at most 4 rows unless one request alone is larger."""
    import concurrent.futures
    import time

    from eeg_image_decode_tpu_torch.server import _Coalescer

    calls = []

    def fn(rows, k):
        calls.append(rows["eeg"].shape[0])
        time.sleep(0.05)  # the device's time: lets a backlog form
        return rows["eeg"][:, 0, 0][:, None] * np.ones((1, k)), rows["sids"]

    def one(co, i, n):
        eeg = np.full((n, 2, 3), float(i), np.float32)
        scores, sids = co.submit({"eeg": eeg, "sids": np.full(n, i,
                                                              np.int32)}, k=2)
        assert scores.shape == (n, 2) and (scores == i).all()
        assert (sids == i).all()
        return n

    lock = threading.Lock()
    for max_rows in (64, 4):
        co = _Coalescer(fn, lock, max_rows=max_rows)
        calls.clear()
        sizes = [1 + i % 3 for i in range(12)]
        with concurrent.futures.ThreadPoolExecutor(12) as ex:
            assert sum(ex.map(lambda a: one(co, *a),
                              enumerate(sizes))) == sum(sizes)
        assert sum(calls) == sum(sizes) and len(calls) < 12, calls
        assert max(calls) <= max_rows, calls
    calls.clear()
    assert one(co, 7, 9) == 9 and calls == [9]


def test_server_without_coalescing_answers_as_the_service(small):
    """``EEGDecodeServer(coalesce=False)``: each request is served alone
    under the device lock (JAX's ``_dispatch`` when ``coalesce`` is False),
    with the same answers as the service called directly, concurrent
    clients included."""
    _, _, model, gallery, eeg = small
    svc = RetrievalService(model, gallery, max_batch=8, device="cpu")
    server = EEGDecodeServer(retrieval=svc, coalesce=False)
    seen = []
    top_k = svc.top_k
    svc.top_k = lambda e, s, k: seen.append(len(e)) or top_k(e, s, k=k)
    port = server.start(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        results = {}

        def client(i):
            results[i] = _post(base + "/v1/retrieve",
                               _npz(eeg=eeg[i:i + 2], subject_ids=np.int32(1),
                                    k=np.int64(3)),
                               "application/octet-stream")[1]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert seen == [2, 2, 2, 2]
        for i in range(4):
            np.testing.assert_array_equal(
                results[i]["indices"], top_k(eeg[i:i + 2], 1, k=3)[1])
    finally:
        server.stop()


def test_cli_serve_builds_the_service(tmp_path):
    """``serve --weights`` at full ATM-S width, fp32 on the CPU: the
    service's answers equal the JAX model's top-k on the same weights; and
    without ``--device cpu`` the command raises on a host without CUDA."""
    rng = np.random.default_rng(22)
    eeg = rng.normal(size=(3, 63, 250)).astype(np.float32)
    sids = np.asarray([0, 3, 9], np.int32)
    jax_model = jax_build_encoder("atms", config=JaxATMSConfig())
    variables = randomize(jax_model.init(
        jax.random.key(0), jnp.asarray(eeg[:2]), jnp.asarray(sids[:2]),
        deterministic=True), 4)
    save_flat_npz(variables, str(tmp_path / "w.npz"))
    gallery = _gallery(rng, 20, 1024)
    np.savez(tmp_path / "g.npz", img_features=gallery)

    args = cli.build_parser().parse_args([
        "serve", "--weights", str(tmp_path / "w.npz"),
        "--features", str(tmp_path / "g.npz"), "--dtype", "float32",
        "--max-batch", "8", "--device", "cpu"])
    assert args.fn is cli.cmd_serve
    svc = cli.build_retrieval(args)
    _, got_i = svc.top_k(eeg, sids, k=5)
    feats, scale = jax_model.apply(variables, jnp.asarray(eeg),
                                   jnp.asarray(sids), deterministic=True)
    logits = float(scale) * np.asarray(feats) @ gallery.T
    np.testing.assert_array_equal(got_i, np.argsort(-logits, axis=1)[:, :5])

    if not torch.cuda.is_available():
        args = argparse.Namespace(**{**vars(args), "device": "cuda"})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.build_retrieval(args)
