"""HTTP serving daemon (counterpart of ``eeg_image_decode_tpu/server.py``)
for the retrieval, reconstruction and caption services:

    POST /v1/retrieve     → {"scores": [[...]], "indices": [[...]]}
    POST /v1/reconstruct  → .npz bytes {"images": (B, H, W, 3) float32}
    POST /v1/caption      → {"captions": ["..."]}
    GET  /healthz         → {"ok": true, "services": [...]}

Request bodies are either JSON (``{"eeg": [[[...]]], "subject_ids": [...],
"k": 5, "seed": 0}``) or ``application/octet-stream`` carrying an ``.npz``
with ``eeg``/``subject_ids`` arrays (binary path — no JSON float overhead;
use it for real batches). The reconstruction answer is an ``.npz`` as the
JAX daemon's, written uncompressed (``np.load`` reads either; zlib over
float images costs the host more than the bytes cost localhost).

Design notes:
- One card: requests of any size are chunked by the service's
  ``max_batch`` (see :mod:`serve`), and a global lock serializes device
  work — HTTP threads handle I/O concurrently while the card executes one
  batch at a time. The device work itself runs on one long-lived thread:
  PyTorch keeps cuDNN's execution plans per thread, so a call from each
  request's fresh handler thread would build them anew (≈ 1 s more for a
  16-row reconstruct request on an NVIDIA H100 80GB HBM3 at 700 W,
  ``scripts/profile_torch_reconstruct.py``).
  :meth:`EEGDecodeServer.warmup` warms the services on that thread.
- One ``_Coalescer`` per service batches the requests that queue while the
  card is busy into one dispatch. A reconstruction or caption request's
  rows carry their (seed, row) pairs, so a row's image or caption does not
  depend on what it was coalesced with. ``coalesce=False`` serves each
  request alone under the device lock, as the JAX daemon's option does.
"""

from __future__ import annotations

import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from eeg_image_decode_tpu_torch.serve import (
    _check_request,
    _default_row_seeds,
)


class _Coalescer:
    """Dynamic request batching (leader–follower): while the device runs one
    batch, arriving requests pile into ``_pending``; whichever thread next
    wins the device lock drains the WHOLE compatible backlog, concatenates
    the row arrays, runs the service once, and demuxes per-request results.
    Under C concurrent clients this turns C serial dispatches into ~1
    batched dispatch per device slot.

    ``fn(rows, **kw) → per-row result`` takes a dict of row-aligned arrays
    (``eeg``, ``sids``) and must return a tuple of row-aligned arrays (the
    service's contract). Requests are only coalesced when their extra kwargs
    (k) AND their per-row trailing shapes match — a wrong-shaped request must
    fail alone, never poison a merged dispatch. ``max_rows`` bounds one
    drained batch (the service's own ``max_batch`` chunking makes any bound
    safe, so it is a fairness knob, not a correctness one); a request
    larger than it rides alone.
    """

    def __init__(self, fn, device_lock: threading.Lock, *,
                 max_rows: int = 4096):
        self._fn = fn
        self._device_lock = device_lock
        self._max_rows = max_rows
        self._mu = threading.Lock()
        self._pending: list[dict] = []

    def submit(self, rows: dict, **kw):
        n = next(iter(rows.values())).shape[0]
        item = {
            "rows": rows, "n": n, "kw": kw,
            "event": threading.Event(), "out": None, "err": None,
        }
        with self._mu:
            self._pending.append(item)
        with self._device_lock:
            # drain FIFO groups until OUR item is served: an earlier leader
            # may have batched it already (event set before we got the
            # lock), and the last thread standing must never exit leaving
            # its own (or anyone's reachable) group stranded
            while not item["event"].is_set():
                self._drain_as_leader()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    @staticmethod
    def _sig(item: dict) -> tuple:
        """Coalescing compatibility signature: kwargs + the trailing shape
        AND dtype of every row array (same-shape different-dtype requests
        must not merge — np.concatenate would silently upcast one of them,
        changing its result vs being served alone)."""
        return (
            tuple(sorted(item["kw"].items())),
            tuple(sorted((k, v.shape[1:], v.dtype.str)
                         for k, v in item["rows"].items())),
        )

    def _drain_as_leader(self):
        """Called WITH the device lock held: serve the oldest pending
        group (compatible prefix of the FIFO queue, bounded by max_rows)."""
        with self._mu:
            if not self._pending:
                return
            sig = self._sig(self._pending[0])
            kw = self._pending[0]["kw"]
            batch, rest, rows = [], [], 0
            for it in self._pending:
                fits = not batch or rows + it["n"] <= self._max_rows
                if self._sig(it) == sig and fits:  # oversize rides alone
                    batch.append(it)
                    rows += it["n"]
                else:
                    rest.append(it)
            self._pending = rest
        try:
            merged = {
                k: np.concatenate([it["rows"][k] for it in batch], axis=0)
                for k in batch[0]["rows"]
            }
            out = self._fn(merged, **kw)
            start = 0
            for it in batch:
                m = it["n"]
                it["out"] = _slice_rows(out, start, start + m)
                start += m
        except Exception as e:  # pragma: no cover - per-request error fanout
            for it in batch:
                it["err"] = e
        finally:
            for it in batch:
                it["event"].set()


def _slice_rows(out: tuple, lo: int, hi: int) -> tuple:
    """Row-slice a service result (a tuple of arrays)."""
    return tuple(np.asarray(o)[lo:hi] for o in out)


class EEGDecodeServer:
    """The retrieval, reconstruction and caption services behind one HTTP
    daemon.

    ``retrieval``, ``reconstruction``, ``caption``: a ``RetrievalService``,
    ``ReconstructionService`` and ``CaptionService`` of
    :mod:`eeg_image_decode_tpu_torch.serve`, or None. An absent service's
    route answers 501 (service not configured), as the JAX daemon does.
    ``coalesce``: batch concurrent requests per service (default), or serve
    each alone, one at a time under the device lock.
    """

    def __init__(self, *, retrieval=None, reconstruction=None, caption=None,
                 coalesce: bool = True):
        self.retrieval = retrieval
        self.reconstruction = reconstruction
        self.caption = caption
        self.coalesce = coalesce
        self._device_lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # every device call runs on this one thread (per-thread cuDNN
        # plans: the module docstring)
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="device")

        def on_device(fn):
            return lambda rows, **kw: self._device.submit(fn, rows,
                                                          **kw).result()

        # the services over the coalescer's (rows, **kw) convention, shared
        # by the coalesced and the lock-serialised paths. Seeded services
        # take per-row seeds, not a batch seed: a row's noise must not
        # depend on what it was merged with.
        self._calls = {
            "retrieval": on_device(lambda rows, k: self.retrieval.top_k(
                rows["eeg"], rows["sids"], k=k)),
            "reconstruction": on_device(
                lambda rows: (self.reconstruction.reconstruct(
                    rows["eeg"], rows["sids"], row_seeds=rows["row_seeds"]),
                )),
            "caption": on_device(lambda rows: (np.asarray(
                self.caption.caption(rows["eeg"], rows["sids"],
                                     row_seeds=rows["row_seeds"]),
                dtype=object),)),
        }
        # one coalescer per service, all on the single device lock: the
        # batching happens in the queue that forms while the card runs the
        # current batch
        self._coalescers = {name: _Coalescer(fn, self._device_lock)
                            for name, fn in self._calls.items()}

    def _dispatch(self, name: str, rows: dict, **kw):
        if self.coalesce:
            return self._coalescers[name].submit(rows, **kw)
        with self._device_lock:
            return self._calls[name](rows, **kw)

    def warmup(self, eeg_shape: tuple[int, int]) -> None:
        """Each configured service's ``warmup`` on the device thread, so
        the per-thread state it builds (cuDNN's plans, cuBLAS's handles)
        is the one requests use."""
        for svc in (self.retrieval, self.reconstruction, self.caption):
            if svc is not None:
                self._device.submit(svc.warmup, eeg_shape).result()

    # ——— request decoding ———

    @staticmethod
    def _parse(body: bytes, content_type: str) -> dict:
        if "octet-stream" in content_type:
            with np.load(io.BytesIO(body), allow_pickle=False) as z:
                out = {k: z[k] for k in z.files}
            # scalars ride along as 0-d arrays
            for k in ("k", "seed"):
                if k in out:
                    out[k] = int(np.asarray(out[k]))
            return out
        req = json.loads(body.decode("utf-8"))
        if "eeg" in req:
            req["eeg"] = np.asarray(req["eeg"], np.float32)
        if "subject_ids" in req:
            req["subject_ids"] = np.asarray(req["subject_ids"], np.int32)
        return req

    @staticmethod
    def _require(req: dict, *keys) -> list:
        missing = [k for k in keys if k not in req]
        if missing:
            raise ValueError(f"missing field(s): {missing}")
        return [req[k] for k in keys]

    # ——— handlers ———

    _ROUTES = {
        "/v1/retrieve": "retrieval",
        "/v1/reconstruct": "reconstruction",
        "/v1/caption": "caption",
    }

    def _handle(self, route: str, req: dict) -> tuple[bytes, str]:
        """→ (response body, content type)."""
        name = self._ROUTES.get(route)
        if name is None:
            raise FileNotFoundError(route)
        if getattr(self, name) is None:
            raise LookupError(f"{name} service not configured")
        eeg, sids = self._require(req, "eeg", "subject_ids")
        eeg = np.asarray(eeg, np.float32)
        rows = {"eeg": eeg, "sids": self._row_sids(eeg, sids)}
        if name != "retrieval":
            rows["row_seeds"] = _default_row_seeds(eeg.shape[0],
                                                   int(req.get("seed", 0)))
            (out,) = self._dispatch(name, rows)
            if name == "caption":
                return (json.dumps({"captions": [str(c) for c in out]}
                                   ).encode(), "application/json")
            buf = io.BytesIO()
            np.savez(buf, images=np.asarray(out, np.float32))
            return buf.getvalue(), "application/octet-stream"
        scores, idx = self._dispatch(name, rows, k=int(req.get("k", 5)))
        return (
            json.dumps(
                {"scores": np.asarray(scores).tolist(),
                 "indices": np.asarray(idx).tolist()}
            ).encode(),
            "application/json",
        )

    @staticmethod
    def _row_sids(eeg: np.ndarray, sids) -> np.ndarray:
        """Validate + materialize per-row subject ids BEFORE coalescing: a
        scalar id must not broadcast over someone else's rows in a merged
        batch, and a malformed request must 400 at the door instead of
        poisoning the whole coalesced dispatch it would ride in."""
        _, sids = _check_request(eeg, sids)
        return sids

    # ——— daemon plumbing ———

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    services = [
                        n for n in ("retrieval", "reconstruction", "caption")
                        if getattr(server, n) is not None
                    ]
                    self._send(
                        200,
                        json.dumps({"ok": True, "services": services}).encode(),
                        "application/json",
                    )
                else:
                    self._send(404, b'{"error": "not found"}',
                               "application/json")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    req = server._parse(
                        body, self.headers.get("Content-Type", "")
                    )
                    out, ctype = server._handle(self.path, req)
                    self._send(200, out, ctype)
                except FileNotFoundError:
                    self._send(404, b'{"error": "not found"}',
                               "application/json")
                except LookupError as e:
                    self._send(
                        501, json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._send(
                        400, json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )
                except Exception as e:  # device-side failures → 500
                    self._send(
                        500, json.dumps({"error": str(e)}).encode(),
                        "application/json",
                    )

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start in a daemon thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8080):
        """Blocking variant (the CLI entry point)."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.serve_forever()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
