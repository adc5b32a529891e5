"""Command line of the port (counterpart of ``eeg_image_decode_tpu/cli.py``).
Ported: ``features``, ``serve``, ``train-retrieval``, ``train-recon``,
``evaluate``, ``export-checkpoint``, ``train-prior``, ``train-lowlevel``,
``latents``, ``generate``, ``caption``, ``train-adapter``, ``metrics`` and
``smoke``.

    python -m eeg_image_decode_tpu_torch.cli features \\
        --images-dir THINGS/images_set/test_images --split test \\
        --clip-params clip.pkl --vocab vocab.json --merges merges.txt
    python -m eeg_image_decode_tpu_torch.cli train-retrieval \\
        --data-path DATA --features clip.npz --subjects sub-01
    python -m eeg_image_decode_tpu_torch.cli train-retrieval --joint \\
        --subjects all --test-subject sub-01 ...
    python -m eeg_image_decode_tpu_torch.cli train-retrieval \\
        --resume-dir runs/contrast/atms/sub-01/<run> ...
    python -m eeg_image_decode_tpu_torch.cli train-retrieval --encoder nice \\
        --data-path DATA --features clip.npz --subjects sub-01
    python -m eeg_image_decode_tpu_torch.cli smoke
    python -m eeg_image_decode_tpu_torch.cli evaluate \\
        --run-dir runs/contrast/atms/sub-01/<run> ...
    python -m eeg_image_decode_tpu_torch.cli serve \\
        --run-dir runs/contrast/atms/sub-01/<run> [--joint] \\
        --features gallery.npz [--dtype bfloat16] [--max-batch 256] \\
        [--fused-projection] [--exact-gelu] [--host 127.0.0.1 --port 8080]
    python -m eeg_image_decode_tpu_torch.cli export-checkpoint \\
        --run-dir runs/contrast/atms/sub-01/<run> --out atms.pth
    python -m eeg_image_decode_tpu_torch.cli train-prior \\
        --eeg-features feats.npz --output-dir runs/prior [--resume-dir DIR]
    python -m eeg_image_decode_tpu_torch.cli train-lowlevel \\
        --data-path DATA --subjects sub-08 --latents latents.npz \\
        --output-dir runs/lowlevel [--resume-dir DIR] \\
        [--preview-dir previews --vae-params vae.pkl]
    python -m eeg_image_decode_tpu_torch.cli latents \\
        --images-dir THINGS/images_set/test_images --vae-params vae.pkl
    python -m eeg_image_decode_tpu_torch.cli generate \\
        --eeg-features feats.npz --prior-params runs/prior/diffusion_prior.pkl \\
        [--generator-params gen.pkl] [--init-latents lat.npz] --seeds 10
    python -m eeg_image_decode_tpu_torch.cli train-adapter \\
        --embeddings clip.npz --images-dir THINGS/images_set/training_images \\
        --git-vision-params git_vit.pkl [--test-embeddings E --test-grids G]
    python -m eeg_image_decode_tpu_torch.cli caption \\
        --eeg-features feats.npz --prior-params diffusion_prior.pkl \\
        --git-params git.pkl --projector-params runs/pixel_projector.pkl \\
        --vocab vocab.txt --out semantic_level_caption.txt
    python -m eeg_image_decode_tpu_torch.cli metrics \\
        --generated generated/ --ground-truth THINGS/test_images_flat \\
        --backbone-params backbones.pkl --clip-params clip_l14.pkl \\
        --out table.csv

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

``train-prior`` trains the diffusion prior on the ``.npz`` that
``train-retrieval --export-features`` writes (``eeg_features`` →
``img_features``) and writes ``<dir>/diffusion_prior.pkl`` (the JAX
package's ``prior-v1`` pickle) beside ``<dir>/ckpt/``. ``train-lowlevel``
trains the EEG → VAE-latent encoder on one subject's training EEG and
``--latents`` (key ``latents``, one per EEG trial, NCHW or NHWC).

``serve`` restores a ``train-retrieval`` run (``--run-dir``, its latest
checkpoint or ``--step``), or loads ``--weights``, the JAX ATM-S variable
tree saved with ``utils/convert.py::save_flat_npz``; without either the
weights are random, drawn from ``--seed`` (a smoke run). With
``--prior-params`` it also serves ``/v1/reconstruct``: that encoder → the
prior → SDXL-turbo + IP-Adapter (``--generator-params``, the JAX
generator's pickle, or seeded random weights) → the VAE decode; with
``--git-params`` (and ``--projector-params``, ``--vocab``) also
``/v1/caption``: that encoder → the prior → ``PixelProjector`` → GIT's
greedy decode → WordPiece. ``generate`` renders the test classes' images
from ``--eeg-features`` through the prior and the generator; ``latents``
writes the SDXL-VAE latent cache of an image directory.
``train-adapter`` trains the ``PixelProjector`` (CLIP embedding → GIT's
visual tokens) on ``--grids`` or on grids it encodes from ``--images-dir``
through GIT's ViT-L/14 tower (``--git-vision-params``, the JAX tower's
pickle) and pickles its JAX param tree; ``caption`` writes one caption
per row of ``--embeddings``, or of the prior's samples for
``--eeg-features``, through GIT (``--git-params``, the JAX decoder's
pickle, and ``--projector-params``; seeded random weights without them).
``metrics`` scores ``generate``'s tree (or a flat image directory, or an
``.npy``) against the ground-truth images: PixCorr, SSIM and a 2-way and a
distance row per backbone of ``--backbone-params`` and for ``--clip-params``.
``--encoder`` takes any name of ``models/registry.py::ENCODERS``
(``atms``, the default, built from its ``ATMSConfig`` flags; ``nice``,
``eegnetv4``, ``atme``, ``mlp``, ``shallowfbcspnet``, ``eegconformer``,
``metaeeg``, ``atcnet``, ``eegitnet`` at their defaults) in
``train-retrieval``, ``train-recon``, ``evaluate`` and ``serve``;
``export-checkpoint`` is ATM-S's only. ``smoke`` is JAX's synthetic end to
end run: NICE, then the prior, then the prior's samples scored.
Every command runs on the CUDA card (``--device cuda``, the default,
raises without one).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
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
from eeg_image_decode_tpu_torch.models.registry import (
    build_encoder,
    encoder_key,
)
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


def _build_model(args, *, device, **atms_fields):
    """``--encoder`` as the JAX CLI builds it: ``atms`` from an
    ``ATMSConfig`` (``--joint`` and ``atms_fields``), any other name at its
    module's defaults (JAX ``cli.py:222-227``), in ``--dtype`` with seeded
    random weights."""
    kw = dict(dtype=_DTYPES[args.dtype], device=device, seed=args.seed)
    if encoder_key(args.encoder) == "atms":
        return build_encoder("atms", config=ATMSConfig(
            joint_train=args.joint, **atms_fields), **kw)
    return build_encoder(args.encoder, **kw)


def build_retrieval(args) -> RetrievalService:
    """The retrieval service ``serve`` puts behind the daemon (which warms
    it up on its device thread):
    the model of a ``train-retrieval`` run (``--run-dir``), JAX weights
    (``--weights``), or seeded random weights when neither is given."""
    if args.weights and args.run_dir:
        raise SystemExit("give --run-dir (a run of train-retrieval) or "
                         "--weights (JAX variables), not both")
    model = _build_model(
        args, device=args.device, exact_gelu=args.exact_gelu,
        fused_projection=True if args.fused_projection else "auto")
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
    return RetrievalService(model, gallery, max_batch=args.max_batch,
                            transfer_dtype=args.transfer_dtype,
                            device=args.device)


def _generator_config(args, prior_embed_dim: int):
    """The generator's config: SDXL-turbo at 512 px, or ``--tiny``; a
    ``--resolution`` sets the latent size. A random-weight ``--tiny`` run
    takes the prior's embedding width for the IP-Adapter input (a full-width
    1024-d prior through the tiny generator); with ``--generator-params``
    the weights' own shapes decide."""
    from eeg_image_decode_tpu_torch.gen.sdxl import GeneratorConfig

    gcfg = GeneratorConfig.tiny() if args.tiny else GeneratorConfig()
    if getattr(args, "resolution", None):
        # the reference's recombination stage renders at 1024²
        # (1x1024_reconstruct_sdxl.ipynb cells 20-27); latents are pixel/8
        factor = gcfg.pixel_factor
        if args.resolution % factor:
            raise SystemExit(
                f"--resolution must be a multiple of the VAE factor "
                f"{factor}; got {args.resolution}")
        side = args.resolution // factor
        gcfg = dataclasses.replace(gcfg, latent_size=(side, side))
    if (args.tiny and not args.generator_params
            and gcfg.unet.ip_image_embed_dim != prior_embed_dim):
        gcfg = dataclasses.replace(gcfg, unet=dataclasses.replace(
            gcfg.unet, ip_image_embed_dim=int(prior_embed_dim)))
    return gcfg


def _build_generator(args, prior_embed_dim: int):
    """``Generator4Embeds`` on ``--device``: bf16 at full width, fp32 with
    ``--tiny``; weights from ``--generator-params`` (the JAX generator's
    ``{"unet", "vae"}`` pickle of numpy arrays), else random N(0, 0.02)
    ones drawn on the device from ``--seed`` (0 for ``generate``; a smoke
    run)."""
    from eeg_image_decode_tpu_torch.gen.sdxl import Generator4Embeds
    from eeg_image_decode_tpu_torch.utils.convert import load_numpy_pickle

    gen = Generator4Embeds(_generator_config(args, prior_embed_dim),
                           dtype=torch.float32 if args.tiny
                           else torch.bfloat16, device=args.device)
    if args.generator_params:
        gen.load_params(load_numpy_pickle(args.generator_params))
    else:
        gen.init_random(seed=getattr(args, "seed", 0))
    return gen


def _load_prior(args):
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    # a prior-v1 pickle brings its own config; a bare tree takes the guess
    return PriorPipe.from_checkpoint(
        args.prior_params,
        default_cfg=PriorConfig.tiny() if args.tiny else PriorConfig(),
        device=args.device)


def build_reconstruction(args, model):
    """The reconstruction service ``serve --prior-params`` adds (the
    daemon warms it up on its device thread):
    ``model`` (the retrieval service's encoder) → the prior of
    ``--prior-params`` → the generator (``--generator-params`` or random),
    ``--gen-batch`` rows per chunk."""
    from eeg_image_decode_tpu_torch.serve import ReconstructionService

    pipe = _load_prior(args)
    gen = _build_generator(args, pipe.cfg.embed_dim)
    return ReconstructionService(model, pipe, gen, max_batch=args.gen_batch,
                                 device=args.device)


def _captioner(args, embed_dim: int):
    """(GIT, its PixelProjector) on ``--device``, both fp32 as the JAX CLI
    runs them: the decoder's shape derived from ``--git-params`` (the JAX
    decoder's pickle), the projector from ``--projector-params``; without
    ``--git-params`` seeded random weights (0 and 1; a smoke run) at the
    ``git_large_coco`` (``--tiny``: tiny) widths, the projector taking
    ``embed_dim``-wide embeddings."""
    from eeg_image_decode_tpu_torch.models.git_caption import (
        GITCaptioner,
        GITConfig,
        PixelProjector,
        git_config_from_params,
    )
    from eeg_image_decode_tpu_torch.utils.convert import (
        load_numpy_pickle,
        pixel_projector_state_dict_from_flax,
    )

    cfg = GITConfig.tiny() if args.tiny else GITConfig.git_large_coco()
    dev = resolve_device(args.device)
    if args.git_params:
        if not args.projector_params:
            raise SystemExit("--git-params needs --projector-params (the "
                             "trained PixelProjector adapter; see "
                             "train-adapter)")
        tree = load_numpy_pickle(args.git_params)
        proj_tree = load_numpy_pickle(args.projector_params)
        # the decoder's shape from the weights: a base-shaped checkpoint
        # must not run under a large-shaped model
        cfg = git_config_from_params(
            tree, max_text_len=cfg.max_text_len,
            num_visual_tokens=cfg.num_visual_tokens,
            bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
            pad_token_id=cfg.pad_token_id)
        embed_dim = int(np.shape(proj_tree["proj"]["kernel"])[0])
    with torch.device(dev):
        git = GITCaptioner(cfg)
        proj = PixelProjector(cfg.num_visual_tokens, embed_dim,
                              cfg.visual_dim)
    if args.git_params:
        git.load_params(tree)
        proj.load_state_dict(pixel_projector_state_dict_from_flax(proj_tree),
                             strict=True)
    else:
        git.init_random(0)
        proj.init_random(1)
    return git.eval(), proj.eval()


def build_caption(args, model, prior):
    """The caption service ``serve --git-params`` adds: ``model`` (the
    retrieval service's encoder) → ``prior`` → the projector and GIT of
    ``--projector-params`` / ``--git-params`` → ``--vocab``'s WordPiece,
    ``--gen-batch`` rows per chunk, ``--max-new-tokens``."""
    from eeg_image_decode_tpu_torch.data.tokenizers import WordPieceTokenizer
    from eeg_image_decode_tpu_torch.serve import CaptionService

    git, proj = _captioner(args, prior.cfg.embed_dim)
    return CaptionService(model, prior, git, proj,
                          WordPieceTokenizer.from_file(args.vocab),
                          max_batch=args.gen_batch,
                          max_new_tokens=args.max_new_tokens,
                          device=args.device)


def build_server(args) -> EEGDecodeServer:
    """The daemon of ``serve``, its services warmed up on its device
    thread: ``/v1/retrieve`` always, ``/v1/reconstruct`` with
    ``--prior-params``, ``/v1/caption`` with ``--git-params``."""
    if args.git_params and not args.prior_params:
        raise SystemExit("--git-params needs --prior-params (captions "
                         "sample CLIP embeddings from the prior)")
    if args.git_params and not (args.projector_params and args.vocab):
        raise SystemExit("--git-params needs --projector-params and "
                         "--vocab to serve /v1/caption")
    retrieval = build_retrieval(args)
    reconstruction = (build_reconstruction(args, retrieval.model)
                      if args.prior_params else None)
    caption = (build_caption(args, retrieval.model, reconstruction.prior)
               if args.git_params else None)
    server = EEGDecodeServer(retrieval=retrieval,
                             reconstruction=reconstruction, caption=caption)
    server.warmup((args.channels, args.timepoints))
    return server


def cmd_serve(args) -> None:
    server = build_server(args)
    routes = ", ".join(r for r, on in (
        ("/v1/retrieve", True), ("/v1/reconstruct", server.reconstruction),
        ("/v1/caption", server.caption)) if on)
    print(f"serving {routes} on http://{args.host}:{args.port}", flush=True)
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
    model = _build_model(args, device=args.device)

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
    model = _build_model(args, device=device,
                         exact_gelu=getattr(args, "exact_gelu", False))
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
        step = ckpt.latest_step() if args.step is None else args.step
        held = torch.load(os.path.join(ckpt_dir, str(step), "state.pt"),
                          map_location="cpu", weights_only=True)["model"]
        if not any(k.startswith("encoder.embedding.") for k in held):
            tops = sorted({k.split(".")[1] for k in held
                           if k.startswith("encoder.")})
            raise SystemExit(
                f"export-checkpoint writes ATM-S's reference layout, and "
                f"the run under {args.run_dir} is not ATM-S's (its encoder "
                f"holds {tops}): the reference has no such file for the "
                "other encoders") from None
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


def cmd_train_prior(args):
    """The diffusion prior on exported (EEG feature, image embedding)
    pairs; prints the last history row."""
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    _refuse_scale_out(args)
    with np.load(args.eeg_features) as d:
        c_emb, h_emb = d["eeg_features"], d["img_features"]
    cfg = PriorConfig(epochs=args.epochs or 150,
                      batch_size=args.batch_size or 1024,
                      lr=args.lr or 1e-3, seed=args.seed)
    pipe = PriorPipe(cfg, device=args.device)
    out_dir = args.resume_dir or args.output_dir
    history = pipe.train(c_emb, h_emb,
                         checkpointer=Checkpointer(os.path.join(out_dir,
                                                                "ckpt")),
                         resume=bool(args.resume_dir))
    pipe.save_with_config(os.path.join(out_dir, "diffusion_prior.pkl"))
    print(json.dumps(history[-1]))
    return history


#: ``train-lowlevel --tiny``: widths a CPU trains in seconds (the output is
#: still 4 × 64 × 64)
TINY_STAGES, TINY_TIME_PROJ = (32, 16, 8, 8, 8, 8), 8


def cmd_train_lowlevel(args):
    """The EEG → VAE-latent encoder on one subject's training EEG; prints
    the last history row."""
    from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        load_things_eeg_subject,
    )
    from eeg_image_decode_tpu_torch.models.lowlevel import EncoderLowLevel
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer

    _refuse_scale_out(args)
    if args.preview_dir and not args.vae_params:
        raise SystemExit("--preview-dir needs --vae-params (frozen VAE)")
    if args.vae_params and not args.preview_dir:
        raise SystemExit("--vae-params is read only with --preview-dir")
    eeg, _ = load_things_eeg_subject(_resolve_data_path(args), args.subjects,
                                     train=True)
    with np.load(args.latents) as d:
        latents = d["latents"]
    cfg = LowLevelConfig(n_channels=eeg.shape[1], seq_len=eeg.shape[2],
                         time_proj_dim=TINY_TIME_PROJ if args.tiny else 128,
                         epochs=args.epochs or 200,
                         batch_size=args.batch_size or 30,
                         lr=args.lr or 1e-3)
    model = None
    if args.tiny:
        model = EncoderLowLevel(n_channels=cfg.n_channels,
                                seq_len=cfg.seq_len,
                                time_proj_dim=cfg.time_proj_dim,
                                stage_channels=TINY_STAGES)
    trainer = LowLevelTrainer(cfg, model=model, device=args.device)
    if args.preview_dir:
        trainer.set_preview_decoder(_load_vae(args),
                                    preview_dir=args.preview_dir,
                                    preview_every=args.preview_every)
    out_dir = args.resume_dir or args.output_dir
    history = trainer.train(
        eeg, latents, seed=args.seed,
        checkpointer=Checkpointer(os.path.join(out_dir, "ckpt")),
        resume=bool(args.resume_dir))
    print(json.dumps(history[-1]))
    return history


# ——— generation: latents / generate ———


def _load_vae(args):
    """The SDXL VAE (``--tiny``: the tiny VAE in fp32; else bf16) on
    ``--device`` with the weights of ``--vae-params``: the JAX VAE's param
    tree as a pickle of numpy arrays, raw or under the ``"vae"`` key of a
    generator dict."""
    from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig
    from eeg_image_decode_tpu_torch.utils.convert import load_numpy_pickle

    tree = load_numpy_pickle(args.vae_params)
    if isinstance(tree, dict) and "vae" in tree:
        tree = tree["vae"]
    device = resolve_device(args.device)
    with torch.device("meta"):
        vae = VAE(VAEConfig.tiny() if args.tiny else VAEConfig.sdxl(),
                  dtype=torch.float32 if args.tiny else torch.bfloat16)
    vae.to_empty(device=device)
    vae.load_state_dict({k[len("vae."):]: v for k, v in
                         params_from_flax({"vae": tree}).items()},
                        strict=True)
    return vae.eval()


def _list_image_files(root: str) -> list[str]:
    """Sorted recursive listing of image files (the THINGS ``images_set``
    layout is ``<root>/<class_dir>/<img>.jpg``; flat dirs work too)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not out:
        raise SystemExit(f"no images found under {root}")
    return out


def cmd_latents(args):
    """The content-keyed SDXL-VAE latent cache of an image directory (the
    low-level pipeline's ``train/test_image_latent_512.pt`` caches,
    ``Generation/eegdatasets_leaveone_latent_vae_no_average.py:62-70``),
    through the port's VAE; prints the cache file."""
    from eeg_image_decode_tpu_torch.data.features import (
        VAELatentEncoder,
        cache_path,
        load_or_compute_vae_latents,
    )

    size = args.image_size or (16 if args.tiny else 512)
    enc = VAELatentEncoder(_load_vae(args), image_size=size,
                           device=args.device)
    paths = _list_image_files(args.images_dir)
    t0 = time.perf_counter()
    latents = load_or_compute_vae_latents(
        args.cache_dir, args.split, paths, encoder=enc,
        batch_size=args.batch_size or 8)
    row = {"n_images": len(paths), "latent_shape": list(latents.shape),
           "cache": cache_path(args.cache_dir, f"sdxl-vae-{size}",
                               args.split, paths),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row))
    return row


def _read_lines(path: str, n: int, flag: str, keep_empty: bool) -> list:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if keep_empty or ln.strip()]
    if len(lines) != n:
        raise SystemExit(f"{flag} has {len(lines)} lines, need one per test "
                         f"class ({n})")
    return lines


def _init_latents(args, gcfg, n: int):
    """``--init-latents`` (.npy or .npz, first array): one latent per test
    class, NCHW or NHWC, at the generation latent size → NCHW fp32."""
    d = np.load(args.init_latents)
    lat = np.asarray(d[d.files[0]] if hasattr(d, "files") else d, np.float32)
    if lat.shape[0] != n:
        raise SystemExit(
            f"--init-latents rows ({lat.shape[0]}) must align with the EEG "
            f"test features ({n})")
    if lat.shape[1] != gcfg.vae.latent_channels:
        lat = np.ascontiguousarray(lat.transpose(0, 3, 1, 2))
    if tuple(lat.shape[2:4]) != tuple(gcfg.latent_size):
        raise SystemExit(
            f"--init-latents spatial size {tuple(lat.shape[2:4])} does not "
            f"match the generation latent size {tuple(gcfg.latent_size)} "
            f"(resolution {gcfg.latent_size[0] * gcfg.pixel_factor}px); "
            "re-export the low-level latents at this resolution or drop "
            "--resolution")
    return lat


def _text_encoder(args, gcfg):
    """(encode(prompts) → (context, pooled), the encoded '') from
    ``--text-encoder-params`` (the JAX encoder's ``{"te1", "te2"}``
    pickle) and ``--tokenizer-dir`` (vocab.json + merges.txt)."""
    from eeg_image_decode_tpu_torch.data.tokenizers import CLIPBPETokenizer
    from eeg_image_decode_tpu_torch.gen.text_encoder import (
        SDXLTextEncoder,
        SDXLTextEncoderConfig,
        tiny_text_encoder_config,
    )
    from eeg_image_decode_tpu_torch.utils.convert import load_numpy_pickle

    te_cfg = (tiny_text_encoder_config(gcfg.unet, args.tokenizer_dir)
              if args.tiny else SDXLTextEncoderConfig())
    files = [os.path.join(args.tokenizer_dir, f)
             for f in ("vocab.json", "merges.txt")]
    ctx_len = te_cfg.clip_l.context_length
    tok1 = CLIPBPETokenizer.from_files(*files, context_length=ctx_len)
    tok2 = CLIPBPETokenizer.from_files(*files, pad_token="!",
                                       context_length=ctx_len)
    enc = SDXLTextEncoder(te_cfg, device=args.device)
    enc.load_flax_params(load_numpy_pickle(args.text_encoder_params))
    return lambda prompts: enc.encode(prompts, tok1, tok2)


def cmd_generate(args):
    """n-seed image generation for every test class from prior-sampled
    embeddings (the reference's ``Generation_metrics_sub8.ipynb`` cell 9
    driver): ``<output>/<sub>/<class-name>/<seed>.png`` with
    ``--class-names``/``--sub``, ``class_%04d/<seed>.png`` otherwise.
    Prints one JSON row: the counts, the device seconds (sampling and
    generation, ending in the images' readback) and the host's PNG
    seconds."""
    from PIL import Image

    with np.load(args.eeg_features) as d:
        feats_test = d["eeg_features_test"]
    n = feats_test.shape[0]
    pipe = _load_prior(args)
    gen = _build_generator(args, pipe.cfg.embed_dim)
    gcfg = gen.config
    dev = gen.device

    encode_prompts = None
    if args.text_encoder_params and args.tokenizer_dir:
        # encode '' once as the default conditioning (ref
        # custom_pipeline.py:239 — not zeros)
        encode_prompts = _text_encoder(args, gcfg)
        gen.set_default_text_conditioning(*encode_prompts([""]))
    captions = None
    if args.captions_file:
        if encode_prompts is None:
            raise SystemExit("--captions-file needs --text-encoder-params "
                             "and --tokenizer-dir to encode the prompts")
        captions = _read_lines(args.captions_file, n, "--captions-file",
                               keep_empty=True)
    init_latents = (_init_latents(args, gcfg, n) if args.init_latents
                    else None)
    class_names = (_read_lines(args.class_names, n, "--class-names",
                               keep_empty=False) if args.class_names
                   else None)
    out_root = (os.path.join(args.output_dir, args.sub) if args.sub
                else args.output_dir)
    os.makedirs(out_root, exist_ok=True)
    bs = args.gen_batch

    def pad_rows(a):
        # the last batch padded with its last row: every batch one shape
        return np.concatenate([a, np.repeat(a[-1:], bs - len(a), 0)]) \
            if len(a) < bs else a

    device_s = png_s = 0.0
    for start in range(0, n, bs):
        t0 = time.perf_counter()
        real = min(bs, n - start)
        emb = pipe.generate(
            pad_rows(feats_test[start:start + bs]),
            generator=torch.Generator(device=dev).manual_seed(start))
        kw = {}
        if captions is not None:
            prompts = captions[start:start + real]
            ctx_b, pooled_b = encode_prompts(prompts + [prompts[-1]]
                                             * (bs - real))
            kw.update(text_context=ctx_b, pooled_text_embed=pooled_b)
        if init_latents is not None:
            kw.update(init_latents=pad_rows(init_latents[start:start + bs]),
                      img2img_strength=args.img2img_strength)
        arrays = []
        for seed in range(args.seeds):
            imgs = gen.generate(
                emb, generator=torch.Generator(device=dev).manual_seed(
                    1000 + seed), **kw)
            arrays.append(torch.round(imgs[:real] * 255).to(torch.uint8))
        arrays = [a.cpu().numpy() for a in arrays]
        t1 = time.perf_counter()
        device_s += t1 - t0
        for seed, arr in enumerate(arrays):
            for j in range(real):
                cls = start + j
                cls_dir = os.path.join(out_root, class_names[cls]
                                       if class_names else f"class_{cls:04d}")
                os.makedirs(cls_dir, exist_ok=True)
                Image.fromarray(arr[j]).save(os.path.join(cls_dir,
                                                          f"{seed}.png"))
        png_s += time.perf_counter() - t1
    row = {"n_classes": n, "seeds": args.seeds, "images": n * args.seeds,
           "resolution": gcfg.latent_size[0] * gcfg.pixel_factor,
           "output_dir": out_root, "device_s": device_s, "png_s": png_s}
    print(json.dumps(row))
    return row


# ——— captioning: caption / train-adapter ———


def cmd_caption(args):
    """Batch semantic-level captioning (the reference's
    ``GIT_caption_batch.ipynb`` cell 8 loop): CLIP embeddings
    (``--embeddings``, or the prior's samples for ``--eeg-features``'
    ``eeg_features_test``, one draw from ``--seed``) → ``PixelProjector`` →
    GIT's greedy decode → one line per row in ``--out`` (WordPiece text
    with ``--vocab``, else the raw ids). Chunks of ``--caption-batch`` rows,
    the last one padded with its last row; prints one JSON row."""
    if args.embeddings:
        d = np.load(args.embeddings)
        if hasattr(d, "files"):  # .npz: a named key, else the first array
            embeds = d["clip_embeds" if "clip_embeds" in d.files
                       else d.files[0]]
        else:
            embeds = d
    elif args.eeg_features and args.prior_params:
        with np.load(args.eeg_features) as d:
            feats_test = d["eeg_features_test"]
        pipe = _load_prior(args)
        embeds = pipe.generate(feats_test, generator=torch.Generator(
            device=pipe.device).manual_seed(args.seed))
    else:
        raise SystemExit("need --embeddings, or --eeg-features + "
                         "--prior-params to sample CLIP embeddings from the "
                         "prior")
    embeds = torch.as_tensor(embeds, dtype=torch.float32)
    git, proj = _captioner(args, embeds.shape[-1])
    tokenizer = None
    if args.vocab:
        from eeg_image_decode_tpu_torch.data.tokenizers import (
            WordPieceTokenizer,
        )

        tokenizer = WordPieceTokenizer.from_file(args.vocab)
    from eeg_image_decode_tpu_torch.models.git_caption import (
        caption_embeddings,
    )

    embeds = embeds.to(git.output.weight.device)
    n = embeds.shape[0]
    bs = min(args.caption_batch, n)
    t0 = time.perf_counter()
    lines: list[str] = []
    for start in range(0, n, bs):
        chunk = embeds[start:start + bs]
        real = chunk.shape[0]
        if real < bs:  # padded: every chunk has one shape
            chunk = torch.cat([chunk, chunk[-1:].expand(bs - real, -1)])
        lines.extend(caption_embeddings(
            git, proj, chunk, tokenizer,
            max_new_tokens=args.max_new_tokens)[:real])
    device_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    row = {"captions": n, "out": args.out, "device_s": device_s}
    print(json.dumps(row))
    return row


def _load_embedding_array(path: str) -> np.ndarray:
    """(N, D) embeddings from ``.npy``/``.npz`` (a named key preferred)."""
    d = np.load(path)
    if hasattr(d, "files"):
        key = next((k for k in ("img_features", "clip_embeds")
                    if k in d.files), d.files[0])
        return np.asarray(d[key], np.float32)
    return np.asarray(d, np.float32)


def _load_grid_array(path: str) -> np.ndarray:
    """(N, T, D) GIT visual-token grids from ``.npy``/``.npz`` (key
    ``grids`` preferred): one resolver for train and test grids."""
    d = np.load(path)
    if hasattr(d, "files"):
        return np.asarray(d["grids" if "grids" in d.files else d.files[0]],
                          np.float32)
    return np.asarray(d, np.float32)


def _git_grid_encoder(args):
    """GIT's CLIP ViT-L/14 grid tower (``--tiny``: the tiny tower in fp32;
    else bf16) on ``--device`` with ``--git-vision-params``, the JAX
    tower's param tree as a pickle of numpy arrays."""
    from eeg_image_decode_tpu_torch.data.features import CLIPFeatureEncoder
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_state_dict_from_flax,
        load_clip_params,
    )

    cfg = (CLIPVisionConfig.tiny() if args.tiny
           else CLIPVisionConfig.git_vit_l_14())
    dev = resolve_device(args.device)
    with torch.device(dev):
        tower = CLIPVisionTower(
            cfg, dtype=torch.float32 if args.tiny else torch.bfloat16)
    tower.load_state_dict(clip_state_dict_from_flax(
        load_clip_params(args.git_vision_params), "vision"), strict=True)
    return CLIPFeatureEncoder(tower, device=dev)


def cmd_train_adapter(args):
    """Train the PixelProjector captioning adapter (the reference's
    ``Generation/image_adapter.ipynb``: ViT-H CLIP image embeddings → GIT's
    frozen ViT-L visual-token grids, MSE, AdamW lr 1e-3, batch 32, 30
    epochs, bf16), pickled as its JAX param tree (the
    ``PixelProjector_best.bin`` analogue; either package reads it). Grid
    targets come from ``--grids`` or are encoded from ``--images-dir``
    through GIT's vision tower into the JAX cache file. Prints one JSON
    row."""
    import pickle

    from eeg_image_decode_tpu_torch.data.features import (
        load_or_compute_git_grids,
    )
    from eeg_image_decode_tpu_torch.train.adapters import (
        AdapterTrainConfig,
        evaluate_pixel_projector,
        train_pixel_projector,
    )
    from eeg_image_decode_tpu_torch.utils.convert import (
        pixel_projector_tree_from_state_dict,
    )

    encoder = None

    def grids_of(images_dir: str, split: str) -> np.ndarray:
        nonlocal encoder
        encoder = encoder or _git_grid_encoder(args)
        return load_or_compute_git_grids(
            args.cache_dir, split, _list_image_files(images_dir),
            encoder=encoder, batch_size=args.grid_batch)

    embeds = _load_embedding_array(args.embeddings)
    if args.grids:
        grids = _load_grid_array(args.grids)
    elif args.images_dir and args.git_vision_params:
        grids = grids_of(args.images_dir, "train")
    else:
        raise SystemExit(
            "need --grids g.npz, or --images-dir + --git-vision-params to "
            "encode the GIT visual-token grids (see data.features."
            "load_or_compute_git_grids)")
    if grids.shape[0] != embeds.shape[0]:
        raise SystemExit(
            f"embeddings ({embeds.shape[0]}) and grids ({grids.shape[0]}) "
            "counts differ — they must describe the same image list")
    cfg = AdapterTrainConfig(epochs=args.epochs or 30,
                             batch_size=args.batch_size or 32,
                             lr=args.lr or 1e-3, seed=args.seed)
    projector, losses = train_pixel_projector(embeds, grids, cfg,
                                              device=args.device)
    out = args.out or os.path.join(args.output_dir, "pixel_projector.pkl")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(pixel_projector_tree_from_state_dict(
            projector.state_dict()), f)
    result = {"out": out, "epochs": cfg.epochs,
              "final_train_loss": losses[-1]}
    if args.test_embeddings:
        test_e = _load_embedding_array(args.test_embeddings)
        if args.test_grids:
            test_g = _load_grid_array(args.test_grids)
        elif args.test_images_dir and args.git_vision_params:
            test_g = grids_of(args.test_images_dir, "test")
        else:
            raise SystemExit(
                "--test-embeddings needs --test-grids or --test-images-dir")
        result["test_mse"] = evaluate_pixel_projector(projector, test_e,
                                                      test_g)
    print(json.dumps(result))
    return result


def _load_image_batch(path: str, *, seed: int, size: int,
                      class_names: list[str] | None = None) -> np.ndarray:
    """Images in [0, 1] NHWC (numpy) from a ``.npy``/``.npz`` array, a
    ``cmd_generate`` output tree (``class_XXXX/<seed>.png`` in sorted
    order, or ``<class-name>/<seed>.png`` in ``class_names`` order, the
    reference's ``generated_imgs/sub-08/<class>/<j>.png`` layout), or a
    flat directory of images (sorted by file name, the reference's ground
    truth order). Files are read and resized by PIL (bilinear) on the host;
    an array is resized as ``jax.image.resize`` does."""
    from PIL import Image

    from eeg_image_decode_tpu_torch.eval.recon_metrics import resize_bilinear

    def load_one(p: str) -> np.ndarray:
        with Image.open(p) as im:
            img = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    if os.path.isfile(path):
        arr = np.load(path)
        if hasattr(arr, "files"):  # .npz: its first array
            with arr as z:
                arr = z[z.files[0]]
        arr = np.asarray(arr, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.shape[1] != size:
            arr = resize_bilinear(torch.from_numpy(arr), size).numpy()
        return arr
    if class_names is not None:
        # directories in test-class order: THINGS class names do not sort
        # in index order
        missing = [c for c in class_names
                   if not os.path.isdir(os.path.join(path, c))]
        if missing:
            raise SystemExit(
                f"{len(missing)} class dirs from --class-names missing under "
                f"{path} (first: {missing[0]!r})")
        return np.stack([load_one(os.path.join(path, c, f"{seed}.png"))
                         for c in class_names])
    entries = sorted(os.listdir(path))
    class_dirs = [e for e in entries if os.path.isdir(os.path.join(path, e))]
    if class_dirs:  # the cmd_generate layout
        return np.stack([load_one(os.path.join(path, c, f"{seed}.png"))
                         for c in class_dirs])
    files = [e for e in entries
             if e.lower().endswith((".png", ".jpg", ".jpeg"))]
    if not files:
        raise SystemExit(f"no images found under {path}")
    return np.stack([load_one(os.path.join(path, f)) for f in files])


def build_metric_extractors(backbone_params: str | None,
                            clip_params: str | None, device
                            ) -> dict[str, Callable]:
    """The extractors of ``cli metrics`` on ``device``, in the table's
    order: ``alexnet2``, ``alexnet5`` (one AlexNet), ``inception``,
    ``effnet``, ``swav`` for the trees the ``--backbone-params`` pickle
    holds (the JAX ``{alexnet, inception, effnet, swav}`` flax trees), and
    ``clip`` for the ``--clip-params`` pickle (the JAX ViT-L/14 vision
    tree); each backbone loaded strictly."""
    from eeg_image_decode_tpu_torch.eval.backbones import (
        BACKBONES,
        make_imagenet_extractor,
    )
    from eeg_image_decode_tpu_torch.eval.recon_metrics import (
        make_clip_extractor,
    )
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from eeg_image_decode_tpu_torch.utils.convert import (
        backbone_state_dict_from_flax,
        load_numpy_pickle,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_state_dict_from_flax,
    )

    def loaded(make, state_dict):
        with torch.device("meta"):
            module = make()
        module.load_state_dict(state_dict, strict=True, assign=True)
        return module.to(device).eval()

    extractors = {}
    if backbone_params:
        bp = load_numpy_pickle(backbone_params)
        models = {kind: loaded(BACKBONES[kind],
                               backbone_state_dict_from_flax(kind, bp[kind]))
                  for kind in ("alexnet", "inception", "effnet", "swav")
                  if kind in bp}
        if "alexnet" in models:  # one AlexNet serves both rows
            for kind in ("alexnet2", "alexnet5"):
                extractors[kind] = make_imagenet_extractor(
                    kind, models["alexnet"])
        for kind in ("inception", "effnet", "swav"):
            if kind in models:
                extractors[kind] = make_imagenet_extractor(kind, models[kind])
    if clip_params:
        tower = loaded(lambda: CLIPVisionTower(CLIPVisionConfig.vit_l_14()),
                       clip_state_dict_from_flax(
                           load_numpy_pickle(clip_params), "vision"))
        extractors["clip"] = make_clip_extractor(tower)
    return extractors


def cmd_metrics(args):
    """The reconstruction metric table (ref ``Reconstruction_Metrics_ATM.
    ipynb`` cells 8-24): PixCorr and SSIM always; a 2-way and a distance
    row for each extractor of :func:`build_metric_extractors`. Prints the
    JSON row, and writes ``metric,value`` lines to ``--out``."""
    from eeg_image_decode_tpu_torch.eval.recon_metrics import (
        reconstruction_metrics,
    )

    device = resolve_device(args.device)
    class_names = None
    if args.class_names:
        with open(args.class_names) as f:
            class_names = [line.rstrip("\n") for line in f if line.strip()]
    gen = _load_image_batch(args.generated, seed=args.gen_seed,
                            size=args.image_size, class_names=class_names)
    gt = _load_image_batch(args.ground_truth, seed=0, size=args.image_size)
    if gen.shape[0] != gt.shape[0]:
        raise SystemExit(
            f"generated ({gen.shape[0]}) and ground-truth ({gt.shape[0]}) "
            "image counts differ — metrics need aligned pairs")
    extractors = build_metric_extractors(args.backbone_params,
                                         args.clip_params, device)
    out = reconstruction_metrics(torch.from_numpy(gen).to(device),
                                 torch.from_numpy(gt).to(device),
                                 extractors or None)
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("metric,value\n")
            for k, v in out.items():
                f.write(f"{k},{v}\n")
        print(f"wrote {args.out}")
    return out


def cmd_smoke(args):
    """The JAX ``smoke`` command: a synthetic end-to-end run. NICE (its
    head to 64-d) trains 4 epochs with the reconstruction objective on 16
    classes × 4 images × 2 repetitions; the diffusion prior trains 300
    epochs on its train features against the scaled image features; the
    prior's samples for the test features are scored 2- and 16-way.
    Prints one JSON row with JAX's keys."""
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    device = resolve_device(args.device)
    train, test = make_synthetic_retrieval_data(
        n_classes=16, images_per_class=4, train_reps=2, clip_dim=64,
        snr=2.0, device=device)
    # the generation path trains the encoder with the reconstruction
    # objective (ref Generation/ATMS_reconstruction.py:227-228)
    cfg = ContrastiveTrainConfig(batch_size=32, epochs=4, lr=1e-3,
                                 eval_ks=(2, 16), recon_loss=True)
    trainer = ContrastiveTrainer(
        build_encoder("nice", proj_dim=64, device=device), cfg, train, test,
        device=device)
    trainer.fit()
    feats_test, _ = trainer.eval_fn(trainer.test_eeg,
                                    trainer.test_subject_ids)
    feats_train, _ = trainer.eval_fn(trainer.data.eeg,
                                      trainer.data.subject_ids)
    scale = train.img_features.abs().max()
    h = train.img_features[train.img_idx.long()] / scale
    pipe = PriorPipe(PriorConfig(
        embed_dim=64, cond_dim=64, hidden_dims=(256, 128, 64),
        time_embed_dim=64, epochs=300, batch_size=64, lr=1e-3,
        warmup_steps=100, num_inference_steps=50, guidance_scale=5.0,
    ), device=device)
    pipe.train(feats_train, h, log_fn=None)
    gen = pipe.generate(feats_test, generator=torch.Generator(
        device=device).manual_seed(0))
    out = retrieval_eval(
        gen, test.img_features / scale, test.labels, ks=(2, 16),
        generator=torch.Generator(device=device).manual_seed(1))
    row = {k: float(v) for k, v in out.items()}
    print(json.dumps(row))
    return row


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
                   help="seed of the random weights when --weights (or "
                        "--generator-params) is absent")
    p.add_argument("--gen-batch", type=int, default=16,
                   help="rows per reconstruction chunk")
    p.add_argument("--prior-params", default=None,
                   help="enable /v1/reconstruct: the diffusion prior's "
                        "pickle (train-prior's diffusion_prior.pkl)")
    p.add_argument("--generator-params", default=None,
                   help="the JAX generator's {'unet', 'vae'} pickle of "
                        "numpy arrays; random weights if absent")
    p.add_argument("--git-params", default=None,
                   help="enable /v1/caption: the JAX GIT decoder's param "
                        "pickle (needs --prior-params, --projector-params, "
                        "--vocab)")
    p.add_argument("--projector-params", default=None,
                   help="trained PixelProjector adapter (train-adapter)")
    p.add_argument("--vocab", default=None,
                   help="WordPiece vocab.txt for caption detokenization")
    p.add_argument("--max-new-tokens", type=int, default=25)
    p.add_argument("--tiny", action="store_true",
                   help="tiny generator (fp32), tiny GIT and tiny-prior "
                        "defaults (tests/smoke)")
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

    p = sub.add_parser("train-prior", help="diffusion prior training")
    _add_common(p)
    p.add_argument("--eeg-features", required=True,
                   help=".npz with eeg_features + img_features (what "
                        "train-retrieval --export-features writes)")
    p.add_argument("--resume-dir", default=None,
                   help="existing run directory: restore the latest "
                        "checkpoint (the full state) and continue")
    _add_scale_out(p, ("--mesh",))
    p.set_defaults(fn=cmd_train_prior)

    p = sub.add_parser("train-lowlevel", help="EEG→VAE-latent training")
    _add_common(p)
    p.add_argument("--subjects", default="sub-08")
    p.add_argument("--latents", required=True,
                   help=".npz with latents, one per EEG trial")
    p.add_argument("--resume-dir", default=None,
                   help="existing run directory: restore the latest "
                        "checkpoint (the full state) and continue")
    p.add_argument("--tiny", action="store_true",
                   help="tiny widths for CPU smoke runs (upsampling stages "
                        "32,16,8,8,8,8, time projection 8) and the tiny "
                        "preview VAE")
    p.add_argument("--preview-dir", default=None,
                   help="periodically decode sample predictions through the "
                        "frozen VAE to PNGs here (ref :309-323)")
    p.add_argument("--preview-every", type=int, default=10)
    p.add_argument("--vae-params", default=None,
                   help="pickled JAX VAE param tree (for --preview-dir)")
    _add_scale_out(p, ("--mesh",))
    p.set_defaults(fn=cmd_train_lowlevel)

    p = sub.add_parser(
        "latents", help="build the SDXL-VAE latent cache from an image dir")
    p.add_argument("--images-dir", required=True)
    p.add_argument("--vae-params", required=True,
                   help="pickled JAX VAE param tree (raw or generator dict)")
    p.add_argument("--cache-dir", default="cache")
    p.add_argument("--split", default="train")
    p.add_argument("--image-size", type=int, default=None,
                   help="default 512 (16 with --tiny)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny VAE config in fp32 (tests/smoke)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_latents)

    p = sub.add_parser("generate",
                       help="prior sampling + SDXL image generation")
    p.add_argument("--eeg-features", required=True,
                   help=".npz with eeg_features_test (train-retrieval "
                        "--export-features)")
    p.add_argument("--prior-params", required=True)
    p.add_argument("--generator-params", default=None,
                   help="the JAX generator's {'unet', 'vae'} pickle of numpy "
                        "arrays; seeded random weights if absent")
    p.add_argument("--text-encoder-params", default=None,
                   help="the JAX SDXL text encoder's {'te1', 'te2'} pickle")
    p.add_argument("--tokenizer-dir", default=None,
                   help="directory with the CLIP vocab.json + merges.txt")
    p.add_argument("--captions-file", default=None,
                   help="semantic-level text prompts, one line per test "
                        "class — needs the text encoder flags")
    p.add_argument("--init-latents", default=None,
                   help=".npy/.npz VAE latents per test class for the "
                        "low-level img2img init (NCHW or NHWC)")
    p.add_argument("--img2img-strength", type=float, default=0.7)
    p.add_argument("--output-dir", default="./generated_imgs")
    p.add_argument("--class-names", default=None,
                   help="file with one THINGS class name per test class: "
                        "write <output>/<sub>/<class-name>/<j>.png")
    p.add_argument("--sub", default=None,
                   help="subject tag level in the output tree, e.g. sub-08")
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--gen-batch", type=int, default=50)
    p.add_argument("--resolution", type=int, default=None,
                   help="output resolution in pixels (default: the config's "
                        "512; the reference's recombination stage uses 1024)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny generator config in fp32 (tests/smoke)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("caption", help="GIT semantic-level batch captioning")
    p.add_argument("--embeddings", default=None,
                   help=".npy/.npz of CLIP image embeddings to caption "
                        "(skips prior sampling)")
    p.add_argument("--eeg-features", default=None,
                   help=".npz with eeg_features_test (train-retrieval "
                        "--export-features)")
    p.add_argument("--prior-params", default=None)
    p.add_argument("--git-params", default=None,
                   help="the JAX GIT decoder's param pickle; seeded random "
                        "weights if absent")
    p.add_argument("--projector-params", default=None,
                   help="PixelProjector params (train-adapter's pickle)")
    p.add_argument("--vocab", default=None,
                   help="WordPiece vocab.txt; raw token ids if absent")
    p.add_argument("--out", default="./semantic_level_caption.txt")
    p.add_argument("--max-new-tokens", type=int, default=25)
    p.add_argument("--caption-batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny GIT config (tests/smoke)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_caption)

    p = sub.add_parser(
        "train-adapter",
        help="train the PixelProjector captioning adapter "
             "(image_adapter.ipynb)")
    p.add_argument("--embeddings", required=True,
                   help=".npy/.npz of ViT-H CLIP image embeddings (the EEG "
                        "encoder's target space)")
    p.add_argument("--grids", default=None,
                   help=".npz of GIT ViT-L visual-token grids (N, 257, 1024)")
    p.add_argument("--images-dir", default=None,
                   help="encode the grids from these images (needs "
                        "--git-vision-params)")
    p.add_argument("--git-vision-params", default=None,
                   help="pickled JAX param tree of GIT's CLIP ViT-L vision "
                        "tower (convert_hf_clip_vision)")
    p.add_argument("--test-embeddings", default=None,
                   help="held-out embeddings for a final test MSE")
    p.add_argument("--test-grids", default=None)
    p.add_argument("--test-images-dir", default=None)
    p.add_argument("--cache-dir", default="cache")
    p.add_argument("--grid-batch", type=int, default=20,
                   help="vision-tower encode batch size")
    p.add_argument("--epochs", type=int, default=None, help="default 30")
    p.add_argument("--batch-size", type=int, default=None, help="default 32")
    p.add_argument("--lr", type=float, default=None, help="default 1e-3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output pickle (default <output-dir>/"
                        "pixel_projector.pkl)")
    p.add_argument("--output-dir", default="./runs")
    p.add_argument("--tiny", action="store_true",
                   help="tiny vision config in fp32 (tests/smoke)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train_adapter)

    p = sub.add_parser("metrics", help="reconstruction metric table")
    p.add_argument("--generated", required=True,
                   help="cmd_generate output dir, flat image dir, or .npy")
    p.add_argument("--ground-truth", required=True,
                   help="flat image dir (sorted) or .npy, aligned with "
                        "--generated")
    p.add_argument("--gen-seed", type=int, default=0,
                   help="which per-class seed image to score")
    p.add_argument("--class-names", default=None,
                   help="file with one THINGS class name per test class: "
                        "read <generated>/<class-name>/<seed>.png in this "
                        "order (the reference's generated_imgs layout; point "
                        "--generated at the <sub> level)")
    p.add_argument("--image-size", type=int, default=425,
                   help="common resize before scoring (MindEye protocol)")
    p.add_argument("--backbone-params", default=None,
                   help="pickle {alexnet/inception/effnet/swav: flax params} "
                        "of numpy arrays (the JAX eval.backbones converters)")
    p.add_argument("--clip-params", default=None,
                   help="JAX CLIP ViT-L/14 vision-tower params (pickle)")
    p.add_argument("--out", default=None, help="CSV output path")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("smoke", help="synthetic end-to-end check")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_smoke)
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
