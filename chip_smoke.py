#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eeg_image_decode_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every CUDA kernel from ``csrc/`` with its time.
2. Each kernel at the serving shapes (B = 256, full ATM-S width) in bfloat16
   and float32: max |Δ| against its plain PyTorch version on the same
   inputs, with the tolerance stated; its time, the plain version's, a
   library yardstick's where one exists (CUDA events, warm, median of 25
   launches); and its bound, the least time the card could take for the
   same work (bytes over 3.35 TB/s or operations over the dtype's peak,
   whichever is larger).
3. The serving path at full width (``ATMSConfig()``, bf16, max_batch 256,
   seeded random weights, a 200 × 1024 L2-normalised gallery): the port's
   ``EEGDecodeServer`` on a free port answers ``/v1/retrieve`` requests of 1,
   8, 37 and 256 rows (npz bodies, k = 5, 64, 200, 5) and one JSON request;
   every answer must equal ``RetrievalService.top_k`` called directly, the
   launch counts (set to 0 just before the requests, read just after) must
   show every kernel of the path, and the top-5 must agree on ≥ 99% of 256
   rows with the same service whose kernels are replaced by their plain
   versions. Then requests/s and p50 latency per bucket. It runs twice:
   with the default (exact-erf) projection head, which launches the
   attention and tsconv kernels, and with ``fused_projection=True``, which
   launches all three.
4. One JSON line listing the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failure raises before the result line, and the exit code is not 0.
Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import urllib.request
from contextlib import ExitStack
from unittest import mock

import numpy as np

SEED = 20200220
BATCH = 256
REPS = 25
#: H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median of ``reps`` warm launches, each between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# ——— phase 2: each kernel against its plain version ———


def kernel_cases(torch):
    """name → (replaces, source, make(dtype) → (kernel fn, plain fn,
    library fn or None, flops, bytes))."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER as ATTN_PARAMS,
        attention_layer_reference,
        fused_attention_layer,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        fused_projection_head,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )
    import torch.nn.functional as F

    dev = "cuda"

    def randn(g, *shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    def attention(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED)
        L, D, H, FF = 64, 250, 4, 256
        inner = (D // H) * H
        shapes = {"wq": (D, inner), "bq": (inner,), "wk": (D, inner),
                  "bk": (inner,), "wv": (D, inner), "bv": (inner,),
                  "wo": (inner, D), "bo": (D,), "ln1_s": (D,), "ln1_b": (D,),
                  "w1": (D, FF), "b1": (FF,), "w2": (FF, D), "b2": (D,),
                  "ln2_s": (D,), "ln2_b": (D,)}
        p = {}
        for k in ATTN_PARAMS:
            s = shapes[k]
            if len(s) == 2:
                p[k] = randn(g, *s, scale=s[0] ** -0.5)
            elif k.endswith("_s"):
                p[k] = randn(g, *s, scale=0.1, shift=1.0)
            else:
                p[k] = randn(g, *s, scale=0.1)
        p = {k: v.to(dtype) for k, v in p.items()}
        x = randn(g, BATCH, L, D).to(dtype)
        sz = x.element_size()
        hd = inner // H
        flops = BATCH * 2 * L * (3 * D * inner + 2 * H * L * hd
                                 + inner * D + 2 * D * FF)
        nbytes = 2 * x.numel() * sz + sum(v.numel() for v in p.values()) * sz
        return (lambda: fused_attention_layer(x, p, H),
                lambda: attention_layer_reference(x, p, H),
                None, flops, nbytes)

    def tsconv(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        C, T, K, Fn, pool, stride = 63, 250, 25, 40, 51, 5
        w_tilde = fold_pool_into_kernel(randn(g, K, Fn, scale=K ** -0.5),
                                        pool).to(dtype)
        x = randn(g, BATCH, C, T).to(dtype)
        M = w_tilde.shape[0]
        P = out_positions(T, M, stride)
        # the JAX TPU default: w~ expanded to a dense (T, P*F) operand,
        # the stage as one matmul (ops/tsconv.py::expand_folded_kernel)
        m = torch.arange(T, device=dev)[:, None] - torch.arange(
            P, device=dev)[None, :] * stride
        valid = (m >= 0) & (m < M)
        e = torch.where(valid[..., None], w_tilde[m.clamp(0, M - 1)],
                        torch.zeros((), dtype=dtype, device=dev))
        e = e.reshape(T, P * Fn)
        x2 = x.reshape(BATCH * C, T)
        sz = x.element_size()
        flops = 2 * BATCH * C * P * M * Fn
        nbytes = (x.numel() + w_tilde.numel() + BATCH * C * P * Fn) * sz
        return (lambda: tsconv_pool_fused(x, w_tilde, stride),
                lambda: tsconv_pool_reference(x, w_tilde, stride),
                lambda: torch.matmul(x2, e), flops, nbytes)

    def projection(dtype):
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        d_in, d_out = 1440, 1024
        p = {"wi": randn(g, d_in, d_out, scale=d_in ** -0.5),
             "bi": randn(g, d_out, scale=0.1),
             "wr": randn(g, d_out, d_out, scale=d_out ** -0.5),
             "br": randn(g, d_out, scale=0.1),
             "ln_s": randn(g, d_out, scale=0.1, shift=1.0),
             "ln_b": randn(g, d_out, scale=0.1)}
        p = {k: v.to(dtype) for k, v in p.items()}
        x = randn(g, BATCH, d_in).to(dtype)
        sz = x.element_size()
        flops = 2 * BATCH * (d_in * d_out + d_out * d_out)
        nbytes = (x.numel() + sum(v.numel() for v in p.values())) * sz \
            + BATCH * d_out * 4

        def library():
            a = torch.matmul(x, p["wi"]) + p["bi"]
            z = torch.matmul(F.gelu(a, approximate="tanh"), p["wr"]) + p["br"]
            return F.layer_norm(a + z, (d_out,), p["ln_s"], p["ln_b"], 1e-6)

        return (lambda: fused_projection_head(x, p),
                lambda: projection_head_reference(x, p),
                library, flops, nbytes)

    return {
        "attention_fwd": ("eeg_image_decode_tpu/ops/attention.py:136",
                          "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
                          attention),
        "tsconv_fwd": ("eeg_image_decode_tpu/ops/tsconv.py:84",
                       "eeg_image_decode_tpu_torch/csrc/tsconv_fwd.cu",
                       tsconv),
        "projection_fwd": ("eeg_image_decode_tpu/ops/projection.py:94",
                           "eeg_image_decode_tpu_torch/csrc/projection_fwd.cu",
                           projection),
    }


#: max |kernel − plain| allowed, with its reason. float32: the two differ in
#: summation order only. bfloat16: both round at the same places, so they
#: differ where an fp32 sum lands on the other side of a bf16 rounding
#: boundary — one bf16 ulp (2^-8 relative) of an intermediate. The attention
#: layer's two LayerNorms can carry that to 2 ulps of an output of magnitude
#: < 8 (2^-4); the tsconv output is rounded once, 2 ulps of a value < 2
#: (2^-6); the projection head's output is fp32 and only g is rounded (4e-3,
#: 5x the error measured on an H100).
TOLERANCE = {
    ("attention_fwd", "float32"): 1e-4,
    ("attention_fwd", "bfloat16"): 2.0 ** -4,
    ("tsconv_fwd", "float32"): 1e-4,
    ("tsconv_fwd", "bfloat16"): 2.0 ** -6,
    ("projection_fwd", "float32"): 1e-4,
    ("projection_fwd", "bfloat16"): 4e-3,
}


def check_kernels(torch) -> dict:
    rows = {}
    for name, (replaces, source, make) in kernel_cases(torch).items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            kern, plain, library, flops, nbytes = make(dtype)
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {dname}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[(name, dname)]
            b_ms, b_by = bound(flops, nbytes, dname)
            row = {
                "phase": "kernel", "name": name, "dtype": dname,
                "shape_batch": BATCH, "max_abs_err": err, "tolerance": tol,
                "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                "library_ms": cuda_ms(torch, library) if library else None,
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes,
            }
            emit(row)
            if not err <= tol:
                raise RuntimeError(f"{name} {dname}: |kernel - plain| = {err}"
                                   f" > {tol}")
            rows[(name, dname)] = dict(row, replaces=replaces, source=source)
    return rows


# ——— phase 3: the serving path through the port's HTTP daemon ———


def _post(url: str, body: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def plain_versions():
    """Patches that swap each kernel wrapper on the serving path for its
    plain version, with the wrapper's own parameter cast."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        attention_layer_reference,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import tsconv_pool_reference

    def cast(p, x):
        return {k: v.to(x.dtype) for k, v in p.items()}

    return [
        mock.patch("eeg_image_decode_tpu_torch.models.atm_s."
                   "fused_attention_layer",
                   lambda x, p, h=4: attention_layer_reference(x, cast(p, x), h)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers.tsconv_pool_fused",
                   lambda x, w, s=5: tsconv_pool_reference(x, w.to(x.dtype), s)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers."
                   "fused_projection_head",
                   lambda x, p: projection_head_reference(x, cast(p, x))),
    ]


def serve_path(torch, variant: str, fused_projection: bool, eeg, sids,
               gallery) -> dict:
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import RetrievalService
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer

    cfg = ATMSConfig(fused_projection=True if fused_projection else "auto")
    model = build_encoder("atms", config=cfg, dtype=torch.bfloat16,
                          device="cuda", seed=SEED)
    svc = RetrievalService(model, gallery, max_batch=BATCH, device="cuda")
    svc.warmup((cfg.n_channels, cfg.seq_len))
    server = EEGDecodeServer(retrieval=svc)
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}/v1/retrieve"
    try:
        requests = [(0, 1, 5), (1, 8, 64), (9, 37, 200), (46, BATCH, 5)]
        _build.reset_launches()
        answers = []
        for lo, n, k in requests:
            out = _post(url, _npz(eeg=eeg[lo:lo + n], subject_ids=sids[lo:lo + n],
                                  k=np.int64(k)), "application/octet-stream")
            answers.append((lo, n, k, out))
        out = _post(url, json.dumps({"eeg": eeg[:3].tolist(),
                                     "subject_ids": sids[:3].tolist(),
                                     "k": 5}).encode(), "application/json")
        answers.append((0, 3, 5, out))
        launches = dict(_build.LAUNCHES)
        n_requests = len(answers)
        required = ["attention_fwd", "tsconv_fwd"] + (
            ["projection_fwd"] if fused_projection else [])
        missing = [k for k in required if launches[k] == 0]
        if missing:
            raise RuntimeError(f"{variant}: the serving path launched no "
                               f"{missing} kernel: {launches}")
        for lo, n, k, out in answers:
            s, i = svc.top_k(eeg[lo:lo + n], sids[lo:lo + n], k=k)
            got_i = np.asarray(out["indices"])
            got_s = np.asarray(out["scores"], np.float32)
            if got_i.shape != (n, k) or not np.array_equal(got_i, i):
                raise RuntimeError(f"{variant}: HTTP answer for {n} rows, "
                                   f"k={k} differs from top_k")
            if not np.array_equal(got_s, s) or not np.isfinite(got_s).all():
                raise RuntimeError(f"{variant}: HTTP scores for {n} rows "
                                   "differ from top_k or are not finite")

        _, idx_kernel = svc.top_k(eeg[:BATCH], sids[:BATCH], k=5)
        with ExitStack() as stack:
            for patch in plain_versions():
                stack.enter_context(patch)
            _build.reset_launches()
            _, idx_plain = svc.top_k(eeg[:BATCH], sids[:BATCH], k=5)
            if any(_build.LAUNCHES.values()):
                raise RuntimeError("the plain service launched a kernel")
        overlap = np.mean([len(set(a) & set(b)) / 5.0
                           for a, b in zip(idx_kernel, idx_plain)])
        exact = float(np.mean(np.all(idx_kernel == idx_plain, axis=1)))
        if overlap < 0.99:
            raise RuntimeError(f"{variant}: top-5 overlap with the plain "
                               f"versions {overlap:.4f} < 0.99")

        latency = {}
        for n in (1, 8, 32, BATCH):
            body = _npz(eeg=eeg[:n], subject_ids=sids[:n], k=np.int64(5))
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                _post(url, body, "application/octet-stream")
                times.append(time.perf_counter() - t0)
            direct = []
            for _ in range(20):
                t0 = time.perf_counter()
                svc.top_k(eeg[:n], sids[:n], k=5)
                direct.append(time.perf_counter() - t0)
            latency[str(n)] = {
                "bucket": next(b for b in svc.buckets if b >= n),
                "http_p50_ms": float(np.median(times)) * 1e3,
                "http_requests_per_s": len(times) / float(np.sum(times)),
                "top_k_p50_ms": float(np.median(direct)) * 1e3,
            }
        row = {"phase": "serve", "variant": variant, "requests": n_requests,
               "launches": launches,
               "launches_per_request": {k: v / n_requests
                                        for k, v in launches.items()},
               "top5_overlap_vs_plain": float(overlap),
               "top5_exact_rows_vs_plain": exact, "latency": latency,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        return row
    finally:
        server.stop()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.utils.device import resolve_device

    card = card_line()
    print(card, flush=True)
    resolve_device("cuda")
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit({"phase": "setup", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "library": so.name})
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("ptxas:", line.strip(), flush=True)

    kernels = check_kernels(torch)

    train, test = make_synthetic_retrieval_data(
        n_classes=200, images_per_class=1, train_reps=2, seed=SEED)
    eeg = np.concatenate([test.eeg, train.eeg])          # 600 × 63 × 250
    sids = np.random.default_rng(SEED).integers(0, 10, len(eeg)).astype(
        np.int32)
    gallery = test.img_features                          # 200 × 1024, unit rows
    serve_rows = [
        serve_path(torch, "default_head", False, eeg, sids, gallery),
        serve_path(torch, "fused_projection", True, eeg, sids, gallery),
    ]

    line = []
    for name in ("attention_fwd", "tsconv_fwd", "projection_fwd"):
        k = kernels[(name, "bfloat16")]
        line.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(r["launches"][name] for r in serve_rows),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
