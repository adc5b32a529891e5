"""Command line of the port (counterpart of ``eeg_image_decode_tpu/cli.py``).
Only ``serve`` is ported:

    python -m eeg_image_decode_tpu_torch.cli serve --weights flat.npz \\
        --features gallery.npz [--dtype bfloat16] [--max-batch 256] \\
        [--fused-projection] [--exact-gelu] [--host 127.0.0.1 --port 8080]

``--weights`` is the JAX ATM-S variable tree saved with
``utils/convert.py::save_flat_npz``; without it the weights are random,
drawn from ``--seed`` (a smoke run). The daemon answers ``/v1/retrieve``
on the CUDA card (``--device cuda``, the default, raises without one).
"""

from __future__ import annotations

import argparse

import torch

from eeg_image_decode_tpu_torch.core.config import ATMSConfig
from eeg_image_decode_tpu_torch.data.features import load_features
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import RetrievalService
from eeg_image_decode_tpu_torch.server import EEGDecodeServer
from eeg_image_decode_tpu_torch.utils.convert import (
    load_flat_npz,
    params_from_flax,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_retrieval(args) -> RetrievalService:
    """The retrieval service ``serve`` puts behind the daemon, warmed up."""
    cfg = ATMSConfig(exact_gelu=args.exact_gelu,
                     fused_projection=True if args.fused_projection else "auto")
    model = build_encoder("atms", config=cfg, dtype=_DTYPES[args.dtype],
                          device=args.device, seed=args.seed)
    if args.weights:
        model.load_state_dict(params_from_flax(load_flat_npz(args.weights)),
                              strict=True)
    feats = load_features(args.features)
    gallery = feats.get("img_features_test", feats.get("img_features"))
    if gallery is None:
        raise SystemExit(f"{args.features} holds neither img_features_test "
                         "nor img_features")
    svc = RetrievalService(model, gallery, max_batch=args.max_batch,
                           device=args.device)
    svc.warmup((cfg.n_channels, cfg.seq_len))
    return svc


def cmd_serve(args) -> None:
    server = EEGDecodeServer(retrieval=build_retrieval(args))
    print(f"serving /v1/retrieve on http://{args.host}:{args.port}",
          flush=True)
    server.serve_forever(host=args.host, port=args.port)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eeg_image_decode_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="HTTP retrieval daemon on the GPU")
    p.add_argument("--weights", default=None,
                   help="JAX ATM-S variables as a flat .npz "
                        "(utils/convert.py::save_flat_npz); random if absent")
    p.add_argument("--features", required=True,
                   help=".npz with the gallery CLIP features "
                        "(img_features_test or img_features)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--fused-projection", action="store_true",
                   help="projection head through its CUDA kernel (tanh GELU)")
    p.add_argument("--exact-gelu", action="store_true",
                   help="exact-erf FFN GELU for checkpoints converted from "
                        "the reference (forces the plain attention layer)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when --weights is absent")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
