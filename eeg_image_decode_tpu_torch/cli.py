"""Command line of the port (counterpart of ``eeg_image_decode_tpu/cli.py``).
Ported: ``features``, ``serve``, ``train-retrieval``, ``train-recon``,
``evaluate`` and ``export-checkpoint``.

    python -m eeg_image_decode_tpu_torch.cli features \\
        --images-dir THINGS/images_set/test_images --split test \\
        --clip-params clip.pkl --vocab vocab.json --merges merges.txt
    python -m eeg_image_decode_tpu_torch.cli train-retrieval \\
        --data-path DATA --features clip.npz --subjects sub-01
    python -m eeg_image_decode_tpu_torch.cli train-retrieval --joint \\
        --subjects all --test-subject sub-01 ...
    python -m eeg_image_decode_tpu_torch.cli train-retrieval \\
        --resume-dir runs/contrast/atms/sub-01/<run> ...
    python -m eeg_image_decode_tpu_torch.cli evaluate \\
        --run-dir runs/contrast/atms/sub-01/<run> ...
    python -m eeg_image_decode_tpu_torch.cli serve \\
        --run-dir runs/contrast/atms/sub-01/<run> [--joint] \\
        --features gallery.npz [--dtype bfloat16] [--max-batch 256] \\
        [--fused-projection] [--exact-gelu] [--host 127.0.0.1 --port 8080]
    python -m eeg_image_decode_tpu_torch.cli export-checkpoint \\
        --run-dir runs/contrast/atms/sub-01/<run> --out atms.pth

Dataset paths come from ``--data-config`` (the reference's
``data_config.json`` format) or ``--data-path``; ``--features`` is a cached
CLIP ``.npz`` (``data/features.py``) with ``img_features``/``text_features``
and, for the 200 test concepts, ``img_features_test``/``text_features_test``
(or a second file, ``--test-features``). A training run writes
``<output-dir>/contrast/<encoder>/<subject>/<run>/`` with ``results.csv`` and
``ckpt/<epoch>/``; ``--resume-dir`` continues such a run from its latest
checkpoint and ``evaluate`` rescores one without retraining.

``features`` writes the CLIP cache that ``--features`` reads, from a
THINGS-layout image directory, through the OpenCLIP ViT-H/14 towers in
bfloat16 (``--tiny``: the tiny towers in float32); ``--clip-params`` is the
JAX package's pickle of ``{'vision': …, 'text': …}`` param trees of numpy
arrays (``utils/convert_clip.py``). ``export-checkpoint`` writes a run's
model in the reference's ``ATMS_retrieval.py`` ``state_dict`` layout.

``serve`` restores a ``train-retrieval`` run (``--run-dir``, its latest
checkpoint or ``--step``), or loads ``--weights``, the JAX ATM-S variable
tree saved with ``utils/convert.py::save_flat_npz``; without either the
weights are random, drawn from ``--seed`` (a smoke run). Every command runs on the CUDA card
(``--device cuda``, the default, raises without one).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import torch

from eeg_image_decode_tpu_torch.core.checkpoint import (
    Checkpointer,
    run_directory,
)
from eeg_image_decode_tpu_torch.core.config import (
    ATMSConfig,
    ContrastiveTrainConfig,
)
from eeg_image_decode_tpu_torch.data.features import load_features
from eeg_image_decode_tpu_torch.data.things_eeg import build_retrieval_data
from eeg_image_decode_tpu_torch.models.registry import build_encoder
from eeg_image_decode_tpu_torch.serve import RetrievalService
from eeg_image_decode_tpu_torch.server import EEGDecodeServer
from eeg_image_decode_tpu_torch.train.contrastive import (
    ContrastiveTrainer,
    create_train_state,
    make_eval_features_fn,
)
from eeg_image_decode_tpu_torch.train.evaluator import retrieval_eval
from eeg_image_decode_tpu_torch.utils.convert import (
    load_flat_npz,
    params_from_flax,
)
from eeg_image_decode_tpu_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_retrieval(args) -> RetrievalService:
    """The retrieval service ``serve`` puts behind the daemon, warmed up:
    the model of a ``train-retrieval`` run (``--run-dir``), JAX weights
    (``--weights``), or seeded random weights when neither is given."""
    if args.weights and args.run_dir:
        raise SystemExit("give --run-dir (a run of train-retrieval) or "
                         "--weights (JAX variables), not both")
    cfg = ATMSConfig(joint_train=args.joint, exact_gelu=args.exact_gelu,
                     fused_projection=True if args.fused_projection else "auto")
    model = build_encoder(args.encoder, config=cfg, dtype=_DTYPES[args.dtype],
                          device=args.device, seed=args.seed)
    if args.weights:
        model.load_state_dict(params_from_flax(load_flat_npz(args.weights)),
                              strict=True)
    elif args.run_dir:
        _restore_run(args, model)
    feats = load_features(args.features)
    gallery = feats.get("img_features_test", feats.get("img_features"))
    if gallery is None:
        raise SystemExit(f"{args.features} holds neither img_features_test "
                         "nor img_features")
    svc = RetrievalService(model, gallery, max_batch=args.max_batch,
                           transfer_dtype=args.transfer_dtype,
                           device=args.device)
    svc.warmup((args.channels, args.timepoints))
    return svc


def cmd_serve(args) -> None:
    server = EEGDecodeServer(retrieval=build_retrieval(args))
    print(f"serving /v1/retrieve on http://{args.host}:{args.port}",
          flush=True)
    server.serve_forever(host=args.host, port=args.port)


# ——— train-retrieval / train-recon / evaluate ———

#: flags of the JAX CLI whose modes the port does not have yet
_SCALE_OUT = {"mesh": "--mesh", "multihost": "--multihost",
              "streaming": "--streaming", "host_dtype": "--host-dtype",
              "shard_data": "--shard-data"}


def _refuse_scale_out(args) -> None:
    for attr, flag in _SCALE_OUT.items():
        if getattr(args, attr, None):
            raise SystemExit(
                f"{flag} is not ported yet: the port trains on one card "
                "with the split resident on it (scale-out: ROADMAP.md §1)")


def _resolve_data_path(args) -> str:
    if args.data_path:
        return args.data_path
    if args.data_config:
        with open(args.data_config) as f:
            return json.load(f)["data_path"]
    raise SystemExit("need --data-path or --data-config")


def _resolve_test_features(args, train_dict):
    """Test-split CLIP features for the retrieval gallery: the 200 test
    concepts are disjoint from the 1654 train concepts, each with its own
    image and text feature. Sources, in order: ``--test-features test.npz``
    (``img_features``/``text_features``), or ``img_features_test``/
    ``text_features_test`` inside ``--features``. A gallery sliced from the
    train features is wrong on real data and is refused."""
    if getattr(args, "test_features", None):
        d = load_features(args.test_features)
        return d["img_features"], d["text_features"]
    if "img_features_test" in train_dict and "text_features_test" in train_dict:
        return train_dict["img_features_test"], train_dict["text_features_test"]
    raise SystemExit(
        "need test-split features: pass --test-features test.npz, or include "
        "img_features_test/text_features_test in the --features file (THINGS "
        "test concepts are disjoint from train concepts — the train features "
        "cannot stand in for the test gallery)")


def _build_retrieval_splits(args, subjects, *, train_exclude=None,
                            test_subject=None, average_test=True):
    """Three protocols (ref scripts): in-subject (subjects=[one], no
    exclusions); joint (train on all subjects, the test subject included,
    test on ``test_subject``); leave-one-out (``train_exclude`` drops the
    test subject from training, test on it)."""
    data_path = _resolve_data_path(args)
    if not args.features:
        raise SystemExit("need --features (a precomputed CLIP cache .npz; "
                         "see eeg_image_decode_tpu_torch.data.features)")
    feats = load_features(args.features)
    test_img, test_txt = _resolve_test_features(args, feats)
    kw = {}
    if getattr(args, "images_per_class", None):
        kw["images_per_class"] = args.images_per_class  # MEG: 12
    if getattr(args, "train_reps", None):
        kw["train_reps"] = args.train_reps  # MEG: 1
    train = build_retrieval_data(
        data_path, subjects, train=True, img_features=feats["img_features"],
        text_features=feats["text_features"], exclude_subject=train_exclude,
        **kw)
    test = build_retrieval_data(
        data_path, subjects, train=False, img_features=test_img,
        text_features=test_txt, exclude_subject=test_subject,
        average_test_reps=average_test)
    return train, test


def _resolve_subjects(args) -> list[str]:
    """``--subjects all`` → every ``sub-*`` directory under the data path."""
    if args.subjects != "all":
        return args.subjects.split(",")
    root = _resolve_data_path(args)
    subs = sorted(d for d in os.listdir(root)
                  if d.startswith("sub-")
                  and os.path.isdir(os.path.join(root, d)))
    if not subs:
        raise SystemExit(f"--subjects all: no sub-* directories under {root}")
    return subs


def _eval_ks(args) -> tuple[int, ...]:
    if getattr(args, "eval_ks", None):
        return tuple(int(k) for k in args.eval_ks.split(","))
    return ContrastiveTrainConfig().eval_ks


def cmd_train_retrieval(args):
    _refuse_scale_out(args)
    subjects = _resolve_subjects(args)
    if getattr(args, "sweep", False):
        return _train_retrieval_sweep(args, subjects)
    return _train_retrieval_one(args, subjects)


def _train_retrieval_sweep(args, subjects):
    """Per-subject sweep: a fresh model per subject, like the reference's
    main loop (``ATMS_retrieval.py:544-583``: in-subject trains and tests on
    each subject in turn; cross-subject leaves each one out of training and
    tests on it). Writes ``<output-dir>/sweep_summary.csv`` with one row per
    subject beside the per-run CSVs."""
    if args.resume_dir:
        raise SystemExit("--sweep does not compose with --resume-dir "
                         "(resume the individual run instead)")
    if args.joint:
        raise SystemExit("--sweep is for the in-subject/cross-subject "
                         "protocols; joint training is one model over all "
                         "subjects already")
    os.makedirs(args.output_dir, exist_ok=True)
    summary = os.path.join(args.output_dir, "sweep_summary.csv")
    rows = []
    for sub in subjects:
        if getattr(args, "cross_subject", False):
            row = _train_retrieval_one(args, subjects, sweep_subject=sub,
                                       protocol="cross")
        else:
            row = _train_retrieval_one(args, [sub], sweep_subject=sub)
        rows.append({"subject": sub, **row})
        # rewritten after every subject: a crash in round k must not
        # discard the k-1 completed rounds
        with open(summary, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    print(f"sweep summary: {summary}")
    print(json.dumps(rows))
    return rows


def _train_retrieval_one(args, subjects, *, sweep_subject=None,
                         protocol=None):
    cfg = ContrastiveTrainConfig(
        batch_size=args.batch_size or (16 if args.joint else 1024),
        epochs=args.epochs or 40,
        lr=args.lr or 3e-4,
        recon_loss=args.recon,
        seed=args.seed,
        eval_ks=_eval_ks(args),
    )
    model = build_encoder(args.encoder,
                          config=ATMSConfig(joint_train=args.joint),
                          dtype=_DTYPES[args.dtype], device=args.device,
                          seed=args.seed)

    test_subject = sweep_subject if protocol == "cross" else args.test_subject
    if protocol == "cross" or getattr(args, "cross_subject", False):
        # leave-one-out: drop the test subject from training
        train, test = _build_retrieval_splits(
            args, subjects, train_exclude=test_subject,
            test_subject=test_subject)
    elif args.joint:
        # joint: all subjects train (the test subject too), eval on one
        train, test = _build_retrieval_splits(
            args, subjects, test_subject=args.test_subject)
    else:
        train, test = _build_retrieval_splits(args, subjects)
    if args.resume_dir:
        out = args.resume_dir
    else:
        run_id = time.strftime("%Y-%m-%d_%H-%M-%S")
        # in a sweep the round's subject names the run directory, never a
        # stray --test-subject, which would put all rounds in one directory
        sub_tag = sweep_subject or test_subject or subjects[0]
        if protocol == "cross":
            sub_tag = f"cross_exclude_{sub_tag}"
        out = run_directory(args.output_dir, args.encoder, sub_tag, run_id)
    ckpt = Checkpointer(os.path.join(out, "ckpt"))
    trainer = ContrastiveTrainer(model, cfg, train, test, output_dir=out,
                                 checkpointer=ckpt, device=args.device)
    if args.resume_dir:
        start = trainer.resume()
        print(f"resumed {out} at epoch {start}")
    trainer.fit()
    if getattr(args, "export_features", None):
        # the reconstruction pipeline's hand-off artifact; in a sweep each
        # subject gets its own file under the given directory
        dest = args.export_features
        if sweep_subject is not None:
            os.makedirs(dest, exist_ok=True)
            dest = os.path.join(dest, f"{sweep_subject}.npz")
        print(f"exported {trainer.export_features(dest)}")
    print(f"run directory: {out}")
    print(json.dumps(trainer.history[-1]))
    return trainer.history[-1]


def _restore_run(args, model) -> int:
    """Load checkpoint ``--step`` (default: the latest) of the run under
    ``--run-dir`` into ``model``, through the train state it was saved
    from; returns the step."""
    state = create_train_state(model, ContrastiveTrainConfig())
    ckpt = Checkpointer(os.path.join(args.run_dir, "ckpt"))
    step = ckpt.latest_step() if args.step is None else args.step
    if step is None:
        raise SystemExit(f"no checkpoints under {args.run_dir}/ckpt")
    try:
        ckpt.restore(step, state)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    except RuntimeError as e:  # load_state_dict: missing or unexpected keys
        raise SystemExit(
            f"could not restore the checkpoint under {args.run_dir}: it does "
            f"not match encoder '{args.encoder}' (joint={args.joint}): {e}"
        ) from e
    return step


def cmd_evaluate(args):
    """Score a trained retrieval checkpoint on the k-way table without
    retraining: restore the train state from a run directory, extract the
    test-set features, run the seeded evaluator. The distractor sets are
    drawn from ``--seed`` itself, as in the JAX CLI; the trainer's
    evaluation after epoch e draws from ``seed + 104729·e``, so that value
    as ``--seed`` reproduces the trainer's row for the same ks."""
    subjects = _resolve_subjects(args)
    data_path = _resolve_data_path(args)
    if not args.features:
        raise SystemExit("need --features (CLIP cache with a test split)")
    feats = load_features(args.features)
    test_img, test_txt = _resolve_test_features(args, feats)
    test = build_retrieval_data(
        data_path, subjects, train=False, img_features=test_img,
        text_features=test_txt, exclude_subject=args.test_subject,
        average_test_reps=not args.no_average)
    device = resolve_device(args.device)
    model = build_encoder(
        args.encoder,
        config=ATMSConfig(joint_train=args.joint,
                          exact_gelu=getattr(args, "exact_gelu", False)),
        dtype=_DTYPES[args.dtype], device=device, seed=args.seed)
    ks = _eval_ks(args)
    step = _restore_run(args, model)
    eval_fn = make_eval_features_fn(model)
    feats_arr, scale = eval_fn(
        torch.as_tensor(test.eeg).to(device, torch.float32),
        torch.as_tensor(test.subject_ids).to(device, torch.int64))
    out = retrieval_eval(
        feats_arr,
        torch.as_tensor(test.class_img_features()).to(device, torch.float32),
        torch.as_tensor(test.labels).to(device, torch.int64), scale, ks=ks,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    row = {"step": int(step), "n_test": int(test.n),
           **{k: float(v) for k, v in out.items()}}
    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            w.writeheader()
            w.writerow(row)
    print(json.dumps(row))
    return row


def cmd_features(args):
    """Build the CLIP feature cache (the ``--features`` / ``--test-features``
    input of train-retrieval) from a THINGS-layout image directory through
    the port's CLIP towers: ViT-H/14 in bfloat16, or with ``--tiny`` the
    tiny towers in float32 under their own cache name. The reference
    computes it inside its dataset class on first use
    (``Retrieval/eegdatasets_leaveone.py:60-74``)."""
    import pickle

    from eeg_image_decode_tpu_torch.data.features import (
        build_clip_encoder,
        clip_cache_path,
        load_or_compute_clip_features,
    )
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        things_images_and_prompts,
    )
    from eeg_image_decode_tpu_torch.data.tokenizers import CLIPBPETokenizer
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPTextConfig,
        CLIPVisionConfig,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import load_clip_params

    tok = CLIPBPETokenizer.from_files(args.vocab, args.merges,
                                      context_length=16 if args.tiny else 77)
    if args.tiny:
        vcfg = CLIPVisionConfig.tiny()
        tcfg = CLIPTextConfig(vocab_size=len(tok.encoder), context_length=16,
                              width=32, layers=2, heads=2,
                              embed_dim=vcfg.embed_dim)
        dtype = torch.float32
    else:
        vcfg = CLIPVisionConfig.vit_h_14()
        tcfg = CLIPTextConfig.vit_h_14()
        dtype = torch.bfloat16
    try:
        params = load_clip_params(args.clip_params)
    except pickle.UnpicklingError as e:
        raise SystemExit(f"--clip-params {args.clip_params}: {e}") from None
    if not (isinstance(params, dict)
            and {"vision", "text"} <= set(params.keys())):
        raise SystemExit(
            "--clip-params must be a pickle of {'vision': ..., 'text': ...} "
            "flax param trees (see the JAX package's utils.convert_clip."
            "convert_openclip_vision/convert_openclip_text)")
    try:
        paths, prompts = things_images_and_prompts(args.images_dir)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    enc = build_clip_encoder(params, vcfg, tcfg, tok, dtype=dtype,
                             device=args.device)
    del params
    normalize = not args.raw
    # tiny runs get their own cache identity: a tiny smoke test and the
    # real ViT-H encode on the same images and split never share a file
    model_name = "tiny-clip" if args.tiny else "ViT-H-14"
    out = load_or_compute_clip_features(
        args.cache_dir, args.split, paths, prompts, encoder=enc,
        model_name=model_name, normalize_img=normalize,
        batch_size=args.batch_size or 20)
    cache = clip_cache_path(args.cache_dir, args.split, paths,
                            model_name=model_name, normalize_img=normalize)
    print(json.dumps({
        "n_images": len(paths), "n_classes": len(prompts),
        "img_shape": list(out["img_features"].shape),
        "text_shape": list(out["text_features"].shape),
        "cache": cache,
    }))
    return enc


def cmd_export_checkpoint(args):
    """A ``train-retrieval`` run → the reference's torch ``.pth`` layout, so
    a model trained here loads into ``ATMS_retrieval.py``'s ``ATMS`` with
    ``load_state_dict`` (``utils/convert.py::export_atms_state_dict``).

    The JAX command tries both ``fused_tsconv`` trees, because its
    checkpoint's tree depends on the training host's backend. The port's
    tree is the same under either (stage 1 always holds
    ``temporal_conv_kernel``), so one restore decides."""
    from eeg_image_decode_tpu_torch.utils.convert import (
        export_atms_state_dict,
    )

    ckpt_dir = os.path.join(args.run_dir, "ckpt")
    ckpt = Checkpointer(ckpt_dir)
    if ckpt.latest_step() is None:
        raise SystemExit(f"no checkpoints under {ckpt_dir}")
    if args.step is not None and args.step not in ckpt.all_steps():
        raise SystemExit(f"step {args.step} not found under {ckpt_dir} "
                         f"(available: {ckpt.all_steps()})")
    model = build_encoder(
        "atms", config=ATMSConfig(joint_train=args.joint,
                                  n_channels=args.channels,
                                  seq_len=args.timepoints),
        device=args.device)
    state = create_train_state(model, ContrastiveTrainConfig())
    try:
        ckpt.restore(args.step, state)
    except RuntimeError as e:  # load_state_dict: missing or unexpected keys
        raise SystemExit(f"could not restore {args.run_dir} "
                         f"(joint={args.joint}): {e}") from None
    # reference ModuleList sizes: ATMS_retrieval.py:172 (2) against
    # ATMS_retrieval_joint_train.py:173 (10)
    num_subjects = args.num_subjects or (10 if args.joint else 2)
    sd = export_atms_state_dict(model.state_dict(), num_subjects=num_subjects)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors)")
    return sd


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-config", default=None,
                   help="path to data_config.json (reference format)")
    p.add_argument("--data-path", default=None)
    p.add_argument("--features", default=None,
                   help=".npz with img_features/text_features "
                        "(data/features.py)")
    p.add_argument("--test-features", default=None,
                   help=".npz with the 200 disjoint test-concept features "
                        "(img_features/text_features); alternatively embed "
                        "img_features_test/text_features_test in --features")
    p.add_argument("--output-dir", default="./runs")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--eval-ks", default=None,
                   help="comma-separated k-way eval sizes (default 2,4,10,"
                        "50,100,200; shrink for small test galleries)")
    p.add_argument("--device", default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eeg_image_decode_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "features",
        help="build the CLIP feature cache (train-retrieval --features "
             "input) from a THINGS-layout image dir")
    p.add_argument("--images-dir", required=True,
                   help="THINGS images root: <dir>/<NNNNN_concept>/<img>.jpg")
    p.add_argument("--clip-params", required=True,
                   help="pickle of {'vision':…,'text':…} converted OpenCLIP "
                        "ViT-H flax trees of numpy arrays (the JAX package's "
                        "utils/convert_clip.py)")
    p.add_argument("--vocab", required=True, help="CLIP BPE vocab.json")
    p.add_argument("--merges", required=True, help="CLIP BPE merges.txt")
    p.add_argument("--cache-dir", default="cache")
    p.add_argument("--split", default="train", help="train or test")
    p.add_argument("--raw", action="store_true",
                   help="skip image-feature L2 normalization (the "
                        "reconstruction pipeline's raw embeddings)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-config towers in float32 (tests/smoke)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_features)

    p = sub.add_parser("serve", help="HTTP retrieval daemon on the GPU")
    p.add_argument("--run-dir", default=None,
                   help="run directory written by train-retrieval (holds "
                        "ckpt/)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to serve (default: latest)")
    p.add_argument("--weights", default=None,
                   help="JAX ATM-S variables as a flat .npz "
                        "(utils/convert.py::save_flat_npz); without it and "
                        "--run-dir the weights are random")
    p.add_argument("--encoder", default="atms")
    p.add_argument("--joint", action="store_true",
                   help="the run was trained with --joint (per-subject "
                        "value embeddings)")
    p.add_argument("--features", required=True,
                   help=".npz with the gallery CLIP features "
                        "(img_features_test or img_features)")
    p.add_argument("--channels", type=int, default=63)
    p.add_argument("--timepoints", type=int, default=250)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--transfer-dtype", default=None,
                   choices=["float16", "float32"],
                   help="host-to-device wire format of the EEG rows "
                        "(float16 halves the copy)")
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

    p = sub.add_parser("train-retrieval",
                       help="contrastive retrieval training")
    _add_common(p)
    p.add_argument("--encoder", default="atms")
    p.add_argument("--subjects", default="sub-01",
                   help="comma list, or 'all' to scan sub-* under the data "
                        "path")
    p.add_argument("--joint", action="store_true",
                   help="joint training over all subjects (per-subject "
                        "value embeddings; batch 16 by default)")
    p.add_argument("--sweep", action="store_true",
                   help="train a fresh model per subject: in-subject per "
                        "listed subject, or with --cross-subject a "
                        "leave-one-out round per subject; writes "
                        "<output-dir>/sweep_summary.csv")
    p.add_argument("--cross-subject", action="store_true",
                   help="leave-one-out: exclude --test-subject from training")
    p.add_argument("--test-subject", default=None)
    p.add_argument("--images-per-class", type=int, default=None,
                   dest="images_per_class",
                   help="train images per concept (EEG 10; THINGS-MEG 12)")
    p.add_argument("--train-reps", type=int, default=None, dest="train_reps",
                   help="repetitions per train image (EEG 4; THINGS-MEG 1)")
    p.add_argument("--resume-dir", default=None,
                   help="existing run directory: restore the latest "
                        "checkpoint (the full train state) and continue")
    p.add_argument("--export-features", default=None, dest="export_features",
                   help="after training, save train+test EEG features and "
                        "the aligned CLIP targets to this .npz")
    _add_scale_out(p, ("--streaming", "--shard-data", "--mesh",
                       "--multihost"), host_dtype=True)
    p.set_defaults(recon=False, fn=cmd_train_retrieval)

    p = sub.add_parser("evaluate",
                       help="k-way retrieval table for a trained checkpoint "
                            "(no retraining)")
    _add_common(p)
    p.add_argument("--run-dir", required=True,
                   help="run directory written by train-retrieval (holds "
                        "ckpt/)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to score (default: latest)")
    p.add_argument("--encoder", default="atms")
    p.add_argument("--subjects", default="sub-01",
                   help="comma list, or 'all' to scan sub-* under the data "
                        "path")
    p.add_argument("--joint", action="store_true",
                   help="the checkpoint was trained with --joint")
    p.add_argument("--test-subject", default=None,
                   help="restrict the test split to this subject")
    p.add_argument("--no-average", action="store_true",
                   help="score per repetition instead of averaging the test "
                        "repetitions")
    p.add_argument("--exact-gelu", action="store_true", dest="exact_gelu",
                   help="exact-erf FFN GELU, for checkpoints converted from "
                        "the reference")
    p.add_argument("--csv", default=None, help="also write the row as CSV")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train-recon",
                       help="reconstruction-objective training")
    _add_common(p)
    p.add_argument("--encoder", default="atms")
    p.add_argument("--subjects", default="sub-08")
    p.add_argument("--resume-dir", default=None)
    p.add_argument("--export-features", default=None, dest="export_features",
                   help="after training, save train+test EEG features and "
                        "the aligned CLIP targets to this .npz")
    _add_scale_out(p, ("--mesh",))
    p.set_defaults(recon=True, joint=False, cross_subject=False,
                   test_subject=None, fn=cmd_train_retrieval)

    p = sub.add_parser(
        "export-checkpoint",
        help="trained ATMS run → reference-format torch .pth "
             "(reverse migration)")
    p.add_argument("--run-dir", required=True,
                   help="train-retrieval run directory (ckpt/ inside)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--joint", action="store_true",
                   help="run was trained with --joint")
    p.add_argument("--num-subjects", type=int, default=None,
                   help="size of the reference's (unused) subject_wise_"
                        "linear ModuleList (default: 2, or 10 with --joint "
                        "— the reference scripts' respective defaults)")
    p.add_argument("--channels", type=int, default=63)
    p.add_argument("--timepoints", type=int, default=250)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_export_checkpoint)
    return ap


def _add_scale_out(p: argparse.ArgumentParser, flags, host_dtype=False):
    """The JAX CLI's scale-out flags: parsed, then refused by the command
    (``_refuse_scale_out``) until those modes are ported."""
    for flag in flags:
        p.add_argument(flag, action="store_true",
                       dest=flag[2:].replace("-", "_"),
                       help="not ported yet (ROADMAP.md): exits")
    if host_dtype:
        p.add_argument("--host-dtype", default=None, choices=["bfloat16"],
                       dest="host_dtype",
                       help="not ported yet (ROADMAP.md): exits")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
