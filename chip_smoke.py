#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eeg_image_decode_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the build of every CUDA kernel from ``csrc/`` with its time,
   and how many tensor-core instructions (HMMA/HGMMA) ``cuobjdump -sass``
   finds in the bfloat16 kernels of the attention forward, backward (its
   rows kernel and its dW products), the tsconv forward and backward and
   the projection head's chain and backward: none is a failure.
2. Each kernel against its plain PyTorch version on the same inputs, in
   bfloat16 and float32, with the tolerance stated, and run twice, bit for
   bit: the three forward kernels at the serving shapes (B = 256; the tsconv
   and projection forwards also once, untimed, at ragged shapes: tsconv at
   37 rows and T 253 and at one position, the head at B 1 and B 37 in its
   three modes), and the training kernels at the training shapes (B = 1024,
   full ATM-S width): the attention forward in mask mode and in seed mode
   (the seed-mode forward must equal the mask-mode forward fed the plain
   Philox draw ``draw_keep_masks``, bit for bit, and in fp32 so must the
   backward), the attention backward (dx and all 16 gradients), the tsconv
   backward (dx and dw̃; also once, untimed, at 37 rows and T 253, no
   multiples of its tiles) and the tsconv forward, each backward through
   ``torch.autograd.grad`` as a training step runs it; every backward twice,
   bit for bit. Every row names the design its dtype took (``mma_bf16`` on
   the tensor cores, ``fma_fp32`` in full float32) and, in bfloat16, the
   first version's time and the device time of the op and of its library
   yardstick, or of its plain version where no library call computes the
   function (the attention layer), from a ``torch.profiler`` trace (the
   event times of short ops are mostly the host's). Per kernel: its time,
   the plain version's, a library yardstick's where one PyTorch call
   computes the same function (CUDA events, warm, median of 25 launches),
   and its bound, the least time the card could take for the same work
   (bytes over 3.35 TB/s or operations over the dtype's peak, whichever is
   larger).
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
   Phase 2 also holds the projection head's training kernels at B = 1024:
   the forward in mask mode and in seed mode (p = 0.5; the seeded forward
   bit-equal to mask mode fed ``draw_keep_mask``, the kept fraction), and
   the backward (dx and the six gradients) through ``torch.autograd.grad``,
   twice, bit for bit, in fp32 bit-equal to mask mode on the plain draw;
   their library yardstick is two matmuls + ``F.gelu(tanh)`` +
   ``F.dropout`` + ``F.layer_norm`` and autograd of that chain.
4. The training path at full width: one subject's split drawn on the card
   from a seed (``make_synthetic_retrieval_data``: 1654 classes × 10 images
   × 4 repetitions = 66,160 × 63 × 250 fp32, plus 200 test classes), then
   ``ContrastiveTrainer`` at ``ATMSConfig()``, batch 1024, bf16, dropout on,
   for one epoch (64 steps) and ``evaluate()``. The launch counts (set to 0
   before the epoch and before the evaluation) must show the seeded
   attention forward, the attention backward and both tsconv kernels once
   per step; the loss must be finite and the mean of the last 8 steps below
   that of the first 8. One step's gradients through the kernels are held
   against the same step through the plain versions (same batch, the seven
   dropout sites pinned to the same masks). Then the step time (p50 of
   per-step CUDA-event times, the first 3 steps left out), samples/s, the
   epoch and evaluation seconds and the peak device memory.
5. The fused-head joint path at full width: the same split with seeded
   subject ids over 0..9, ``ATMSConfig(fused_projection=True,
   joint_train=True)``, a ``Checkpointer`` in a temporary directory.
   ``fit(1)``: the launch counts must show all six training kernels once
   per step (the seeded projection forward and the projection backward
   among them) and the mode-0 projection forward in the evaluation; the
   loss finite and falling; a checkpoint saved. A fresh model and trainer
   ``resume()`` from it and run epoch 1, whose per-step losses are held
   against epoch 1 of the uninterrupted run (|Δ| ≤ 0.05, and whether they
   are bit-equal). One step's gradients through the kernels against the
   plain versions, in seed mode with the same generator seed on both sides
   (the kernels draw in-kernel, the plain versions draw the same bits with
   ``draw_keep_masks`` / ``draw_keep_mask``). Then the step p50 beside
   phase 4's.
6. The CLI: a small THINGS-EEG-shaped tree (two subjects, 30 train classes,
   20 test concepts) and its feature file written to a temporary directory;
   ``cli train-retrieval`` for two epochs at full model width on the card,
   ``--resume-dir`` for a third, then ``cli evaluate`` on the run
   directory, whose row must equal the trainer's last evaluation. Then
   ``cli export-checkpoint`` on that run; the ``.pth`` loads back through
   ``utils/convert.py::convert_atms_state_dict`` bit-equal to the restored
   run, and serves the same top-5 on the tree's test EEG as ``cli
   serve``'s service of the run. The resumed ``train-retrieval`` call also
   exports its features (``--export-features``), on which ``cli
   train-prior`` trains two epochs (its ``diffusion_prior.pkl`` read back
   and sampled), and ``cli train-lowlevel`` trains one epoch on sub-01's
   training EEG with one seeded latent per trial (full model widths),
   decoding its four previews through the full-width SDXL VAE (seeded
   weights written as the JAX VAE's pickle, ``--vae-params``). Then ``cli
   latents`` at 512 px on 20 written 500 × 500 JPEGs through that VAE, and
   ``cli generate`` at full SDXL-turbo width on the run's 20 exported test
   features and the ``train-prior`` pickle: two seeds from noise, and one
   from those latents (``--init-latents``, strength 0.5); 512 × 512 PNGs.
   Then ``cli train-adapter --images-dir`` on 40 written JPEGs through a
   seeded ``git_vit_l_14`` pickle (bf16 grids into the
   ``ViT-L-14-GIT-grid`` cache, a held-out MSE), ``cli caption
   --eeg-features`` on those 20 test features and the ``train-prior``
   pickle through a seeded full-width GIT pickle, the trained projector and
   the 30,522-id stand-in WordPiece vocabulary (20 lines), and ``cli serve
   --git-params`` once (one ``/v1/caption`` request, then it stops).
7. ``cli features`` at the published OpenCLIP ViT-H/14 widths in bf16
   (vision 32 × 1280, text 24 × 1024) from seeded random weights, written
   as the ``--clip-params`` pickle and read back: a 200-concept
   THINGS-layout test tree, one 500 × 500 JPEG per concept, the 49,408-id
   stand-in vocabulary, ``--batch-size 20``. The cache must have the name
   ``clip_cache_path`` gives; its (200, 1024) image and text features must
   be finite and unit-norm, and hold the port's fp32 towers' features on
   the first 20 images and prompts at per-row cosine ≥ 0.99. Then the
   vision tower's rate on device tensors at batch 20 and 256 and its
   largest kernels at batch 20, the host decode ms per image beside the
   device side's, the pickle's write seconds, the command's seconds and
   its peak device memory. No TPU kernel lies on this path (the JAX
   towers are plain XLA), so it adds no row to the kernels line.
8. The diffusion prior at full width (``PriorConfig()``: 1024 → (1024,
   512, 256, 128, 64), fp32). Right after phase 4, its trainer's
   ``export_features`` writes the pairs on the card (the eval forward over
   the 66,160 training and 200 test rows; its launches count into the main
   path). ``PriorPipe`` trains 3 epochs on the 66,160 pairs at B 1024; a
   second pipe launched as the same 3-epoch job trains 2 with a checkpoint
   each, and a fresh pipe resumes it to epoch 3, whose per-step losses and
   final weights must equal the uninterrupted run's bit for bit. Then CFG
   sampling of the 200 test rows, 50 steps at guidance 5.0 (per-row keys:
   each row sampled in a permuted batch and in two smaller batches must
   agree with the full batch within ``REBATCH_TOL``; bit-equality is
   reported), and one training step's kernel launches and device time from
   a ``torch.profiler`` trace. Step p50, epoch seconds, sampling ms and
   samples/s, peak device memory.
9. The low-level encoder at full width (``LowLevelConfig()``, 143 M
   parameters, fp32, no TF32): phase 4's 66,160 × 63 × 250 EEG with one
   latent per trial, 66,160 × 4 × 64 × 64 fp32 (4.3 GB) drawn on the card
   from ``SEED``, B 30: two epochs (2,205 steps each) with a checkpoint
   after each, and a fresh trainer resumed from the first checkpoint,
   whose second epoch must equal the uninterrupted one bit for bit. Step
   p50, epoch seconds, the kernel launches and device time of one step,
   peak device memory and the TF32 settings.
   No TPU kernel lies inside the prior or the low-level encoder (the JAX
   modules are plain XLA), so phases 8-9 add no row to the kernels line.
10. Generation at full width (``GeneratorConfig()``: the SDXL-turbo UNet
   with the IP-Adapter, 2.92 B parameters, and the SDXL VAE, 84 M, bf16,
   built on ``meta`` and filled N(0, 0.02) on the card from ``SEED``):
   parameter counts and weight memory; one UNet call (B 2, 64 × 64
   latents, t = 999) and one VAE decode in bf16 against the same weights
   in fp32, per-row cosine ≥ ``GEN_COSINE``; each stage alone at B 16
   (CUDA events, operations from PyTorch's FLOP counter, the largest
   kernels). Then ``ReconstructionService`` (phase 4's trained encoder,
   phase 8's trained prior at 50 steps and guidance 5.0, ``max_batch``
   16, 4 Euler-ancestral steps at guidance 0, 512 px) behind the HTTP
   daemon: requests of 1, 16 and 20 rows (p50 latency and images/s; the
   images (B, 512, 512, 3), finite, in [0, 1]; the same (seed, row) in
   each within ``GEN_BATCH_TOL``), two requests the coalescer merges
   (each row against the same request served alone, ≤ 2/255, bit-equality
   reported), the attention and tsconv launches of those requests (into
   the main path), and a 16-row request's device milliseconds split into
   encoder, prior, UNet steps and VAE decode, with the device's busy
   time and idle share in a traced one. No TPU kernel lies inside
   the generator (the JAX UNet, VAE and scheduler are plain XLA).
11. Captioning at full width (``GITConfig.git_large_coco()``: 1024 wide,
   6 layers, 16 heads, 30,522 ids, ≈ 140 M parameters, and a full-width
   ``PixelProjector``, fp32 without TF32, filled on the card from
   ``SEED``): parameter count and weight memory; one decoder forward (B 16,
   257 + 26 tokens) and one 16-row greedy decode of 25 new tokens alone
   (CUDA events, operations from PyTorch's FLOP counter, TFLOP/s, the
   largest kernels). Then ``CaptionService`` (phase 4's trained encoder,
   phase 8's trained prior at 50 steps and guidance 5.0, ``max_batch`` 16,
   the stand-in vocabulary) behind the HTTP daemon: requests of 1, 16 and
   20 rows, three each (p50 and captions/s; the HTTP captions equal the
   service's ids decoded; a (seed, row) gives the same ids at the same
   offset in every size), the attention and tsconv launches of those
   requests (into the main path), the prior embeddings equal to
   ``ReconstructionService``'s for the same (seed, row) within
   ``REBATCH_TOL``, two requests the coalescer merges (rows agreeing with
   the same requests alone are counted; where ids differ, the first step
   that differs and its top-2 logit gaps), and a 16-row request's device
   ms split into encoder, prior, projector and decode, with the device's
   busy time and idle share in a traced one. Last, ``train_pixel_projector``
   for one epoch at full size (16,540 × 1024 embeddings and 16,540 × 257 ×
   1024 fp32 grids, 17.4 GB, drawn on the card; B 32, bf16 products): the
   loss finite and falling, the step p50, the epoch seconds, the peak
   memory. No TPU kernel lies inside GIT, the projector or the adapter
   trainer (the JAX modules are plain XLA).
12. The reconstruction metric table at full backbone width, fp32 without
   TF32: AlexNet, InceptionV3, EfficientNet-B1 and ResNet-50 (SwAV) with
   seeded weights written as the JAX ``--backbone-params`` pickle, and the
   CLIP ViT-L/14 vision tower (``CLIPVisionConfig.vit_l_14()``) as the
   ``--clip-params`` pickle. Inside phase 6's directory: ``cli metrics`` on
   its ``cli generate`` tree (``--gen-seed`` 0 and 1) against its 20 written
   JPEGs (copied flat, in concept order: the loader reads ground truth
   from a flat directory, as the reference does), each table with 14 rows
   in JAX's order, finite, PixCorr and SSIM in [−1, 1], the 2-way rows in
   [0, 1], the CSV equal to the printed row; then the 20 JPEGs written as
   a generate tree against a flat copy of themselves (PixCorr and SSIM
   ≥ 0.9999, every distance ≤ 1e-5, every 2-way row 1.0; the seeded
   generator's near-flat images lie closer together than float32 resolves
   in the pooled extractors, so their tree cannot hold the 2-way rows);
   the command's seconds, and the host's PNG/JPEG decode and resize ms per
   image beside the device's table on the same pairs.
   The six extractors' features for 4 of those pairs on the card against
   the same modules on the CPU (max |Δ| ≤ 1e-4 · max |CPU feature|), and
   PixCorr and SSIM (≤ 1e-5). Then the full-size table: 200 pairs at
   425 × 425 drawn on the card from ``SEED`` (uniform images, the ground
   truth those plus 0.05 · N(0, 1), clipped), with per extractor its
   CUDA-event ms over both batches, its operations from PyTorch's FLOP
   counter, TFLOP/s against the fp32 peak and its largest kernels; the
   PixCorr and SSIM ms, the table's total, the peak memory and the
   parameter counts. No TPU kernel lies on this path (the JAX metric
   modules are plain XLA).
13. The encoder zoo: each of the nine encoders besides ATM-S (NICE,
   EEGNetV4, ATM-E, MLP, ShallowFBCSPNet, EEGConformer, MetaEEG, ATCNet,
   EEGITNet) at its defaults, the published widths, in bf16 on the card
   from ``SEED``: its parameter count equal to the flax tree's
   (``ZOO_PARAMS``); ``ContrastiveTrainer`` at B 1024 on phase 4's
   resident split, NICE for one epoch (64 steps) and ``evaluate()``, each
   other encoder for ``ZOO_STEPS`` steps; the step p50 (CUDA events, the
   first 3 left out), samples/s, peak memory and the loss (finite; NICE's
   last 8 steps under its first 8); the eval forward on 4 rows, the card
   in fp32 without TF32 against the CPU within ``ZOO_CPU_TOL`` · max |CPU|
   and bf16 against fp32 at per-row cosine ≥ ``ZOO_COSINE``. NICE's first
   step's gradients through the tsconv kernels against the plain versions
   (seed mode, one generator seed; ``GRAD_TOL``), and its epoch's and
   evaluation's launch counts (from 0) showing both tsconv kernels once per
   step; the other eight reach no kernel (the JAX modules are plain XLA)
   and must launch none. Then NICE through the CLI on phase 6's tree:
   ``train-retrieval --encoder nice`` for two epochs and ``--resume-dir``
   for a third, ``evaluate`` equal to the trainer's last row, ``serve
   --run-dir --encoder nice`` answering an 8-row ``/v1/retrieve`` equal to
   ``top_k`` called directly, and ``cli smoke`` (JAX's keys, values in
   [0, 1]). NICE's launches count into the main path.
14. Raw preprocessing and host-streamed training. (a) ``cli preprocess``
   (epoching and MVNN on the card) on a written raw tree
   (``write_synthetic_raw_tree``: 2 sessions of 300 training conditions ×
   2 reps and 20 test conditions × 20 reps at 1000 Hz, the conditions of
   phase 6's tree), then ``train-retrieval --streaming`` for two epochs on
   its output (251 samples a trial) with phase 6's feature file and
   ``evaluate``, equal to the trainer's last row; the streamed steps must
   launch rows 1′, 3, 4 and 5, the evaluation rows 1 and 4. (c) ``cli
   preprocess-meg`` on a written THINGS-MEG-shaped npz (271 sensors, 281
   samples; an image-level split through ``--image-concept-csv``), its
   pickles read back by the port's loader. (b) At full size: phase 4's
   split copied to the host and trained one epoch each resident, streamed
   from fp32 and from bf16, each through the native gather pool (the
   trainer's own loader, the shared pool) and through the plain
   ``index_select`` gather (``ATMSConfig()``, bf16, B 1024, one seed; every
   streamed epoch's step losses must equal the resident epoch's bit for
   bit): step p50, samples/s, peak memory, launches a step, and from a
   traced second epoch the device's busy ms a step and idle share; the
   loader's gather time in the epoch and the training thread's wait for a
   batch; one batch's gather into pinned memory by ``index_select`` and by
   the pool at its default size (cores − 2) and at JAX's (a thread a
   core), and its host-to-device copy, timed alone. (Phase 18 times the
   full subject's sidecar read through ``NpyMmap``.) Then one
   THINGS-EEG2-sized session drawn on the host (16,540 training events of
   8,270 conditions and 4,000 test events of 200, targets mixed in, 63
   channels + stim at 1000 Hz): the epoch gather + baseline + resample,
   the Ledoit-Wolf covariances and the whitening timed on the card and
   through a numpy copy of the JAX package's functions on the host; the
   card's whitened epochs within ``PREPROCESS_TOL`` of the host's largest.
15. Scale-out over ``torch.distributed`` (``core/mesh.py``,
   ``parallel/``). (a) Each seed-mode kernel at full ATM-S width in bf16:
   the launch over B 512 at ``sample0`` = 512 gives the second half of the
   B 1024 launch's output and dx (attention forward and backward,
   projection forward and backward), bit for bit, and mask mode fed
   ``draw_keep_masks`` / ``draw_keep_mask`` at ``row0`` = 512 the same
   output. (b) This process joins a one-rank NCCL group: an epoch of phase
   4's split (from phase 14's host copy) without and with the mesh from one
   init, the step losses bit-equal, both step p50s, the mesh epoch's
   kernel launches and collectives a step and the evaluation's launches,
   and from a traced second epoch the busy ms and idle share; ``cli
   train-retrieval --mesh`` on a small written tree in this process, its
   last row equal to the command's without ``--mesh``. (d) The fused-head
   joint model (``fused_projection=True, joint_train=True``) for 8 steps
   and an evaluation under the mesh: rows 6, 6′ and 7 launched under dp,
   the losses against the same steps without the mesh. (e) The prior (8,192
   pairs, B 1024) and the low-level trainer (300 trials, B 30) at full
   width, one epoch each without and with the mesh: bit-equal losses. Then
   two rank subprocesses (``chip_smoke.py --rank …``, each with its own time
   limit; a rank that fails or hangs fails the phase) join a gloo group on
   the one card (NCCL refuses two ranks on one device; gloo takes CUDA
   tensors and moves them through the host): (c) ``--shard-data`` at B 1024 global for 8 steps,
   each rank regenerating phase 4's split and keeping its half, against the
   one-rank mesh over the same rows (step 0 within 1e-3, the rest within
   ``RESUME_TOL``), the ranks' losses and parameters bit-equal, each rank's
   peak memory at least half the split below the resident epoch's; (f) the
   subject-parallel sweep, two full-width lanes (lane i on rank i), each
   lane's row and parameters bit-equal to its sequential run made here
   first; (g) the bf16 UNet at full SDXL width from seeded random weights,
   mp = 2, B 2 at 128 × 128 latents: cosine ≥ 0.999 against the unsharded
   forward made here first, with both forwards' seconds. (c), (f) and (g)
   are correctness runs of two processes on one card, not scaling numbers.
16. The acceptance runbook (``scripts/acceptance_torch.py``, in this
   process). (a) ``--dry-run --device cuda``: exit code 0, the report ok,
   all four stages, every PNG written, finite metric rows. (b) Its real
   mode at full width on a written tree in the reference's pickle layout
   (63 channels × 250 samples, class-template EEG from ``SEED``: 200
   training concepts × 10 images × 4 repetitions and 200 test concepts × 4,
   THINGS-EEG's 1,654 training concepts and 80 test repetitions cut as
   the phase prints; written by the runbook's own tree writer),
   ``--epochs-retrieval 2 --epochs-prior 2 --seeds 1 --batch-size 1024``
   with phase 12's metric pickles and no generator weights, so ``generate``
   runs at its default chunk, as a lab's run does: ATM-S in bf16 through rows 1′, 3, 4 and 5, the
   export through rows 1 and 4 (counted into the main path), the prior at
   ``PriorConfig()`` width, SDXL-turbo + IP-Adapter at full width from
   seeded weights, ``cli metrics`` at 425 px. Every stage must run, the
   exported features, the prior pickle, 200 PNGs and a finite 14-row
   table must exist, and the exit code must be ``0 if report["ok"] else
   1``; each stage's status, numbers and seconds (from the runbook's
   report) are printed. The
   retrieval and prior bands are BASELINE.md's for real THINGS data after
   40 and 150 epochs, so their status after 2 synthetic epochs is data,
   not a check.
17. The stage-1 BatchNorm modes of JAX's ``TSConv`` (``ATMSConfig.
   tsconv_bn1``) and bf16 GIT, run after phase 5 on phase 4's split (late
   in a run ``torch.profiler``'s traces came back without the port's
   kernels). (a) The tsconv forward at B 1024, full width, bf16 and
   fp32: without an epilogue bit-equal to the kernel before the epilogue
   existed (``TSCONV_FWD_SHA256``), and with each epilogue mode the model
   takes (``scale_shift_elu`` for ``'gram2d'``, ``shift`` for
   ``'gramfold'``, on the BatchNorm of these inputs) against its plain
   version within two bf16 ulps of the largest output (1e-4 in fp32),
   twice bit for bit, with ms, plain ms, device ms, bound and a library
   yardstick (``torch.addmm`` for ``shift``). (b) One ATM-S training step
   at B 1024 in bf16 under each of ``'flax'``, ``'gram'``, ``'gram2d'``
   and ``'gramfold'`` from one seeded init, batch and dropout seed: the
   gradients' cosine against the ``'flax'`` step (≥ 0.99) and the worst
   parameter's relative L2, then 12 steps for the step p50, the launches
   counted from 0 around each mode's steps (``tsconv_fwd_epilogue`` in
   ``'gram2d'`` and ``'gramfold'``), and BN1's device ms (stage 1 + BN1 +
   ELU forward and backward, less the tsconv kernels alone). (c) The
   default ``ATMSConfig()`` takes ``'gram'`` on the card: its flag, and
   its step's BN1 running statistics bit-equal to the ``'gram'`` model's
   and unlike ``'flax'``'s. (d) GIT at ``git_large_coco()`` from seeded
   weights, a 16-row greedy decode of 25 tokens in bf16 and in fp32: each
   p50 and the share of bf16 ids equal to the fp32 ids.
18. The full-size rehearsals, timed with CUDA events. (a) Every
   published checkpoint's key grammar (``scripts/checkpoint_grammar_
   torch.py``: the sdxl-turbo UNet with ``ip-adapter_sdxl_vit-h``, the
   SDXL VAE, SDXL's two text towers, OpenCLIP ViT-H/14, git-large-coco
   with its ViT-L/14 image encoder, the reference's diffusion prior)
   synthesized from a seed on the card, handed to the host as fp16,
   converted there by the port's converter, loaded ``strict=True`` into
   the module built on ``meta`` and given memory on the card in bf16, and
   run (``scripts/rehearse_fullsize_torch.py``): finite outputs of their
   shapes, the UNet's ε and the VAE's decode each row's cosine ≥ 0.99 to
   the same weights in fp32, one line per model with its elements and
   its convert, load and forward times, its peak device memory and host
   peak RSS. (b) ``train-retrieval`` on one subject at THINGS-EEG's stored
   size (16,540 × 4 × 63 × 300 fp32 in the published pickle layout, 5.00
   GB, and 200 × 80 test repetitions) through the CLI in this process at
   its defaults (bf16, B 1024, ``'gram'``), ``scripts/rehearse_fullscale_
   torch.py``: 2 epochs from cold (the pickles read, the sidecars
   written), the same trainer's uninterrupted third epoch, ``--resume-dir
   … --epochs 4 --export-features`` from the sidecars (its first epoch's
   step losses against the uninterrupted epoch's within ``RESUME_TOL``),
   ``evaluate`` equal to the trainer's last row, ``results.csv`` at epochs
   0-3; the seconds of each write, ingest, epoch, evaluation, checkpoint
   and the export, the step p50 and samples/s, the resident split, peak
   memory and the bytes on disk; each sidecar mapped through
   ``data/native_loader.py::NpyMmap`` with its readahead and read whole,
   beside numpy's ``mmap_mode`` (warm: the page cache is left as it is).
   Its launches (rows 1, 1′, 3, 4 and 5:
   every step of the 5 epochs, every evaluation and the export) count
   into the main path.
19. The long trajectories and the walkthrough, timed with CUDA events,
   each card run in fp32 with TF32 off against the same function on the
   host's CPU. (a) ``PriorPipe`` at ``PriorConfig()``'s widths over 30
   epochs of 4 steps at B 1024 from one seeded init and the injected draws
   of ``scripts/parity_torch_prior_trajectory.py`` (the warmup its
   published share, 6 of 120 steps, then the cosine): the per-epoch
   relative ε-MSE < 1e-4, both trained pipes' CFG samples under shared
   noise at guidance 5.0 and 0 within 1e-3 of their scale, the step p50.
   (b) ``LowLevelTrainer`` (its ``CUDNN_FLAGS``) through its own
   ``train()``, ``scripts/parity_torch_lowlevel_trajectory.py``'s bands
   (the first epoch < 1e-4, every epoch < 1e-3, held-out cross PSNR > 30
   dB, L1 to the targets within 5e-3): stages (128, 64, 32, 16, 16, 16)
   and ``time_proj_dim`` 32 over 8 epochs of 8 steps at B 16, then the
   published widths for one epoch of 2 steps at B 8. (c)
   ``examples/end_to_end_torch.py`` on the card: NICE's steps and
   evaluations launch the tsconv forward and backward, counted into the
   main path; its printed numbers finite and in range.
20. One JSON line listing the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last. The Philox mask draw is a device
   function inside the seeded forwards and the backwards, not a launch of
   its own, so it has no row there: the bit-equalities of phase 2 hold it.
   The forward's two epilogue modes have rows of their own
   (``tsconv_fwd_scale_shift_elu``, ``tsconv_fwd_shift``), their launches
   those of phase 17's ``'gram2d'`` and ``'gramfold'`` steps.
   The mask-mode forwards are reached through the ops only (a pinned mask
   in the model routes around the fused head), so they are reported in
   phase 2 and not in that line.

Any failure raises before the result line, and the exit code is not 0.
Without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import urllib.request
from contextlib import ExitStack
from unittest import mock

import numpy as np

SEED = 20200220
BATCH = 256          # serving
TRAIN_BATCH = 1024   # training (ContrastiveTrainConfig().batch_size)
REPS = 25
#: H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: the nine zoo encoders' parameter counts at their defaults, logit scale
#: included: the flax trees' (``jax.eval_shape``; this host has no JAX, so
#: ``tests/test_torch_zoo.py`` holds these numbers to the trees)
ZOO_PARAMS = {"nice": 2630833, "eegnetv4": 1186833, "atme": 4519690,
              "mlp": 3425460, "shallowfbcspnet": 886845,
              "eegconformer": 635273, "metaeeg": 1828428, "atcnet": 49889,
              "eegitnet": 218037}


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


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device time per call: the sum of the kernels' durations in a
    ``torch.profiler`` trace of ``reps`` warm calls. Unlike :func:`cuda_ms`
    it leaves out the host's time to reach the first launch, which for a
    sub-millisecond op through ``torch.autograd.grad`` is most of the event
    time and moves with the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / reps


def top_kernels(torch, fn, n: int = 8) -> dict:
    """Device ms per call of the ``n`` kernels that take the most of one
    warm call in a ``torch.profiler`` trace, by kernel name, and of all;
    ``launches``: the kernels the call launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    launches = 0
    for e in prof.events():
        # device kernels only: not an optimizer's user-annotation span
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            launches += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:n])
    return {"all": sum(by_name.values()), "launches": launches,
            **{k[:80]: v for k, v in top.items()}}


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


@contextlib.contextmanager
def tf32_off(torch):
    """fp32 products in matmuls and cuDNN for the block, the flags as they
    were after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


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


def forward_design(torch, name: str, dtype, backward: bool = False) -> str:
    """The design the forward (or backward) launcher of ``name`` took for
    ``dtype``: every bfloat16 kernel must be on the tensor cores, every
    float32 one on the FMA code."""
    from eeg_image_decode_tpu_torch.ops import attention, projection, tsconv

    op = {"tsconv": tsconv, "projection": projection,
          "attention": attention}[name.split("_")[0]]
    design = (op.backward_design if backward else op.forward_design)(dtype)
    if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
        raise RuntimeError(f"{name} {dtype} took design {design}")
    return design


def forward_ragged_check(torch, dtype) -> dict:
    """The tsconv and projection forwards once at small ragged shapes,
    untimed, against their plain versions: tsconv at 37 rows (a short
    second tile) and T 253, and at one position (T 77); the head at B 1 and
    B 37 (no multiple of the 64-row tile) in its three modes."""
    from eeg_image_decode_tpu_torch.ops.projection import (
        draw_keep_mask,
        fused_projection_head,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )

    dname = str(dtype).split(".")[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    out = {}
    w = fold_pool_into_kernel(randn(25, 40, scale=0.2), 51).to(dtype)
    tol = TOLERANCE[("tsconv_fwd", dname)]
    for rows, t in ((37, 253), (7, 77)):
        x = randn(1, rows, t).to(dtype)
        err = (tsconv_pool_fused(x, w, 5).float()
               - tsconv_pool_reference(x, w, 5).float()).abs().max().item()
        out[f"tsconv_fwd_rows{rows}_T{t}"] = err
        if not err <= tol:
            raise RuntimeError(f"tsconv_fwd {dname}, {rows} rows, T {t}: "
                               f"{err} > {tol}")
    p = {"wi": randn(D_IN, D_OUT, scale=D_IN ** -0.5),
         "bi": randn(D_OUT, scale=0.1),
         "wr": randn(D_OUT, D_OUT, scale=D_OUT ** -0.5),
         "br": randn(D_OUT, scale=0.1),
         "ln_s": randn(D_OUT, scale=0.1, shift=1.0),
         "ln_b": randn(D_OUT, scale=0.1)}
    p = {k: v.to(dtype) for k, v in p.items()}
    for b in (1, 37):
        x = randn(b, D_IN).to(dtype)
        mask = ((torch.rand(b, D_OUT, generator=g, device="cuda") >= 0.5)
                .float() * 2.0).to(dtype)
        drawn = draw_keep_mask(7, b, D_OUT, 0.5, device="cuda")
        for mode, args, plain_mask in (("none", (), None),
                                       ("mask", (mask,), mask),
                                       ("seed", (None, 0.5, 7), drawn)):
            tol = (TOLERANCE[("projection_fwd", dname)] if mode == "none"
                   else PROJ_FWD_TOL[dname])
            with torch.no_grad():
                err = (fused_projection_head(x, p, *args)
                       - projection_head_reference(x, p, plain_mask)
                       ).abs().max().item()
            out[f"projection_fwd_{mode}_B{b}"] = err
            if not err <= tol:
                raise RuntimeError(f"projection_fwd {mode} {dname}, B {b}: "
                                   f"{err} > {tol}")
    return out


def check_kernels(torch) -> dict:
    rows = {}
    for name, (replaces, source, make) in kernel_cases(torch).items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            kern, plain, library, flops, nbytes = make(dtype)
            got, again = kern(), kern()
            want = plain()
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.equal(got, again)):
                raise RuntimeError(f"{name} {dname}: non-finite output, or "
                                   "a rerun that differs")
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[(name, dname)]
            b_ms, b_by = bound(flops, nbytes, dname)
            extra = {"design": forward_design(torch, name, dtype)}
            if dtype == torch.bfloat16:
                extra["first_version_ms"] = FIRST_VERSION_MS[name]
                extra["device_ms"] = device_ms(torch, kern)
                if library:
                    extra["library_device_ms"] = device_ms(torch, library)
                else:
                    extra["plain_device_ms"] = device_ms(torch, plain)
            row = {
                "phase": "kernel", "name": name, "dtype": dname,
                "shape_batch": BATCH, "max_abs_err": err, "tolerance": tol,
                "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                "library_ms": cuda_ms(torch, library) if library else None,
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes, **extra,
            }
            emit(row)
            if not err <= tol:
                raise RuntimeError(f"{name} {dname}: |kernel - plain| = {err}"
                                   f" > {tol}")
            rows[(name, dname)] = dict(row, replaces=replaces, source=source)
        if name == "projection_fwd":
            for dtype in (torch.bfloat16, torch.float32):
                emit({"phase": "kernel", "check": "forward ragged shapes",
                      "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": forward_ragged_check(torch, dtype)})
    return rows


# ——— phase 2, training kernels: B = 1024, full width ———

L_TOK, D_MODEL, HEADS, D_FF = 64, 250, 4, 256
P_DROP = 0.25
#: backward kernel vs plain, as a share of the largest |plain| value of each
#: output: fp32 differs in summation order only; in bf16 an fp32 sum that
#: lands on the other side of a rounding boundary moves an intermediate by
#: one bf16 ulp (2^-8), and the LayerNorm and softmax backward carry that
#: into their neighbours. The key bias's gradient is zero in exact
#: arithmetic (softmax ignores a shift of the scores), so its error is taken
#: against the largest of the three QKV bias gradients.
BWD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
#: the reasons printed beside each tolerance
TOL_REASON = {
    "float32": "fp32: the two sum in another order, nothing else",
    "attention_fwd_masks": "one bf16 rounding of an intermediate per site, "
                           "2 ulps of an output < 16",
    "attention_fwd_seed": "one bf16 rounding of an intermediate per site, "
                          "2 ulps of an output < 16",
    "attention_bwd": "share of each output's largest |plain|: a bf16 "
                     "rounding flip (2^-8) spread by the LayerNorm and "
                     "softmax backward",
    "tsconv_bwd": "share of each output's largest |plain|: fp32 sums of "
                  "bf16 products, order only",
    "tsconv_fwd": "one rounding to bf16 of fp32 sums of exact products: 2 "
                  "ulps of an output < 2",
    "projection_fwd_masks": "only g is rounded to bf16 and the output is "
                            "fp32: the no-dropout head's 4e-3, twice, since "
                            "a kept z is doubled",
    "projection_fwd_seed": "as projection_fwd_masks",
    "projection_bwd": "share of each output's largest |plain|: a bf16 "
                      "rounding flip (2^-8) of g, d_z or d_a, and the cast "
                      "of the gradients to bf16",
}
#: the projection head's dropout-mode forward vs plain (fp32 output)
PROJ_FWD_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
P_DROP_PROJ = 0.5
D_IN, D_OUT = 1440, 1024
#: kernel names (substrings) that must hold HMMA/HGMMA instructions: the
#: bfloat16 designs of the attention forward (all three dropout modes are
#: one kernel), the attention backward's rows kernel and its dW products,
#: the tsconv forward and backward, the projection head's chain (its
#: forward's launches 1-2, which its backward recomputes) and the
#: backward's own products
TENSOR_CORE_KERNELS = ("attention_fwd_mma_kernel",
                       "attention_bwd_mma_rows_kernel",
                       "attention_dw_mma_kernel",
                       "tsconv_fwd_mma_kernel", "tsconv_bwd_mma_kernel",
                       "projection_chain_a_kernel",
                       "projection_chain_r_kernel", "projection_bwd_da_kernel",
                       "projection_bwd_out_kernel")
#: bfloat16 event times of the first versions of the seven redesigned
#: kernels (fp32 FMA products; PERF.md, H100 80GB HBM3 at 700 W): the
#: backward ops and the forwards in dropout mode at B 1024, the forwards
#: without dropout at B 256. The tsconv forward's first version at B 1024
#: was never timed in this script and is not in this tree;
#: scripts/ab_torch_kernels.py times it beside the redesign.
FIRST_VERSION_MS = {"tsconv_bwd": 4.718, "projection_bwd": 1.757,
                    "tsconv_fwd": 0.265, "projection_fwd": 0.373,
                    "projection_fwd_masks": 0.718,
                    "projection_fwd_seed": 0.647,
                    "attention_fwd": 1.609, "attention_fwd_seed": 5.472,
                    "attention_fwd_masks": 5.864, "attention_bwd": 21.679}
#: why a kernel has no library yardstick
NO_LIBRARY = {
    "attention_fwd_masks": "none: no one PyTorch call computes the layer",
    "attention_fwd_seed": "none: no one PyTorch call computes the layer",
    "attention_bwd": "none: no one PyTorch call computes the layer's "
                     "backward",
}
#: dropout-mode forward vs plain: as the no-dropout layer, but the kept
#: values 1/keep (4/3) scale what enters the LayerNorms, and each site adds
#: a rounding in bf16: 2 ulps of an output of magnitude < 16 (2^-3)
DROPOUT_FWD_TOL = {"bfloat16": 2.0 ** -3, "float32": 1e-4}


def attention_case(torch, dtype, batch: int, seed: int):
    """x (batch, 64, 250), the 16 parameters, a cotangent; in dtype."""
    from eeg_image_decode_tpu_torch.ops.attention import PARAM_ORDER

    g = torch.Generator(device="cuda").manual_seed(seed)
    inner = (D_MODEL // HEADS) * HEADS
    shapes = {"wq": (D_MODEL, inner), "bq": (inner,), "wk": (D_MODEL, inner),
              "bk": (inner,), "wv": (D_MODEL, inner), "bv": (inner,),
              "wo": (inner, D_MODEL), "bo": (D_MODEL,), "ln1_s": (D_MODEL,),
              "ln1_b": (D_MODEL,), "w1": (D_MODEL, D_FF), "b1": (D_FF,),
              "w2": (D_FF, D_MODEL), "b2": (D_MODEL,), "ln2_s": (D_MODEL,),
              "ln2_b": (D_MODEL,)}

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    p = {}
    for k in PARAM_ORDER:
        s = shapes[k]
        if len(s) == 2:
            p[k] = randn(*s, scale=s[0] ** -0.5)
        elif k.endswith("_s"):
            p[k] = randn(*s, scale=0.1, shift=1.0)
        else:
            p[k] = randn(*s, scale=0.1)
    p = {k: v.to(dtype) for k, v in p.items()}
    x = randn(batch, L_TOK, D_MODEL).to(dtype)
    gout = randn(batch, L_TOK, D_MODEL).to(dtype)
    return x, p, gout


def attention_flops(batch: int) -> float:
    inner = (D_MODEL // HEADS) * HEADS
    hd = inner // HEADS
    return batch * 2 * L_TOK * (3 * D_MODEL * inner + 2 * HEADS * L_TOK * hd
                                + inner * D_MODEL + 2 * D_MODEL * D_FF)


def scaled_errors(torch, got: dict, want: dict) -> dict:
    """max |got − want| per output over the largest |want| (the QKV biases
    share the largest scale of the three)."""
    scale = {k: w.float().abs().max().item() for k, w in want.items()}
    bias = max(scale.get(k, 0.0) for k in ("bq", "bk", "bv"))
    out = {}
    for k, w in want.items():
        s = bias if k in ("bq", "bk", "bv") else scale[k]
        out[k] = (got[k].float() - w.float()).abs().max().item() / max(s, 1e-30)
    return out


def tsconv_bwd_ragged_check(torch, dtype, tol: float) -> dict:
    """The tsconv backward once at a small ragged shape, untimed: T 253 (no
    multiple of the stride: the trailing samples get dx = 0) and 37 rows (no
    multiple of the kernel's 32-row tile), against the plain version."""
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_backward_reference,
        tsconv_pool_fused,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    rows, T, K, Fn, pool, stride = 37, 253, 25, 40, 51, 5
    w = fold_pool_into_kernel(
        torch.randn(K, Fn, generator=g, device="cuda") * K ** -0.5,
        pool).to(dtype).requires_grad_()
    P = out_positions(T, w.shape[0], stride)
    x = torch.randn(1, rows, T, generator=g, device="cuda").to(dtype)
    x.requires_grad_()
    gout = torch.randn(1, rows, P, Fn, generator=g, device="cuda").to(dtype)
    dx, dw = torch.autograd.grad(tsconv_pool_fused(x, w, stride), [x, w],
                                 gout)
    dx_p, dw_p = tsconv_pool_backward_reference(x.detach(), w.detach(), gout,
                                                stride)
    torch.cuda.synchronize()
    errs = scaled_errors(torch, {"x": dx, "w_tilde": dw},
                         {"x": dx_p, "w_tilde": dw_p})
    tail_zero = not dx[..., (P - 1) * stride + w.shape[0]:].any().item()
    if not (max(errs.values()) <= tol and tail_zero):
        raise RuntimeError(f"tsconv_bwd {dtype}, 37 rows, T 253: errors "
                           f"{errs}, trailing dx zero {tail_zero}")
    return {"rows": rows, "T": T, "scaled_err": errs,
            "trailing_dx_zero": tail_zero}


def check_training_kernels(torch) -> dict:
    from eeg_image_decode_tpu_torch.ops.attention import (
        MASK_ORDER,
        PARAM_ORDER,
        attention_layer_backward_reference,
        attention_layer_reference,
        draw_keep_masks,
        fused_attention_layer,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        backward_design as tsconv_backward_design,
        fold_pool_into_kernel,
        out_positions,
        tsconv_pool_backward_reference,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )

    B = TRAIN_BATCH
    rows = {}

    def record(name, dname, replaces, source, kern, plain, library, flops,
               nbytes, err, tol, library_desc="dense g2 @ E^T + x2^T @ g2",
               key=None, **extra):
        b_ms, b_by = bound(flops, nbytes, dname)
        reason = TOL_REASON["float32" if dname == "float32" else name]
        row = {"phase": "kernel", "name": name, "dtype": dname,
               "shape_batch": B, "max_abs_err": err, "tolerance": tol,
               "tolerance_reason": reason,
               "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
               "library_ms": cuda_ms(torch, library) if library else None,
               "library": library_desc if library else NO_LIBRARY[name],
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes, **extra}
        emit(row)
        rows[(key or name, dname)] = dict(row, replaces=replaces,
                                          source=source)
        return row

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        sz = torch.tensor([], dtype=dtype).element_size()
        x, p, gout = attention_case(torch, dtype, B, SEED + 10)
        n_par = sum(v.numel() for v in p.values())
        flops = attention_flops(B)
        g = torch.Generator(device="cuda").manual_seed(SEED + 11)
        shapes = {"m_attn": (B, HEADS, L_TOK, L_TOK),
                  "m_res": (B, L_TOK, D_MODEL), "m_ffn1": (B, L_TOK, D_FF),
                  "m_ffn2": (B, L_TOK, D_MODEL)}
        masks = {k: ((torch.rand(s, generator=g, device="cuda") >= P_DROP)
                     .float() / (1 - P_DROP)).to(dtype)
                 for k, s in shapes.items()}
        n_mask = sum(m.numel() for m in masks.values())
        tol_fwd = DROPOUT_FWD_TOL[dname]

        def attn_extra(name, kern, plain, backward=False):
            """The design and, in bf16, the first version's time and the
            device times of the kernel and of its plain version."""
            out = {"design": forward_design(torch, name, dtype, backward)}
            if dtype == torch.bfloat16:
                out.update(first_version_ms=FIRST_VERSION_MS[name],
                           device_ms=device_ms(torch, kern),
                           plain_device_ms=device_ms(torch, plain))
            return out

        # forward, mask mode
        def kern_masks():
            return fused_attention_layer(x, p, HEADS, masks=masks)

        def plain_masks():
            return attention_layer_reference(x, p, HEADS, masks=masks)

        got, again = kern_masks(), kern_masks()
        want = plain_masks()
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        record("attention_fwd_masks", dname,
               "eeg_image_decode_tpu/ops/attention.py:136",
               "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
               kern_masks, plain_masks, None, flops,
               (2 * x.numel() + n_par + n_mask) * sz, err, tol_fwd,
               bit_identical_rerun=repeat,
               **attn_extra("attention_fwd_masks", kern_masks, plain_masks))
        if not (repeat and err <= tol_fwd):
            raise RuntimeError(f"attention_fwd_masks {dname}: rerun "
                               f"bit-equal {repeat}, |Δ| {err}")

        # forward, seed mode: bit-equal to mask mode fed the plain draw
        seed = SEED % (2**31 - 1)
        seed_t = torch.tensor([seed], dtype=torch.int32, device="cuda")
        drawn = draw_keep_masks(seed, B, HEADS, L_TOK, D_MODEL, D_FF, P_DROP,
                                device="cuda")
        kept = {k: float((drawn[k] > 0).float().mean()) for k in MASK_ORDER}
        bad = {k: v for k, v in kept.items() if abs(v - 0.75) > 0.005}
        if bad:
            raise RuntimeError(f"kept fractions off 0.75 ± 0.005: {bad}")
        def kern_seed():
            return fused_attention_layer(x, p, HEADS, dropout_p=P_DROP,
                                         seed=seed_t)

        def plain_seed():
            return attention_layer_reference(x, p, HEADS, masks=drawn)

        got = kern_seed()
        via_masks = fused_attention_layer(x, p, HEADS, masks=drawn)
        want = plain_seed()
        torch.cuda.synchronize()
        same = torch.equal(got, via_masks)
        err = (got.float() - want.float()).abs().max().item()
        record("attention_fwd_seed", dname,
               "eeg_image_decode_tpu/ops/attention.py:136",
               "eeg_image_decode_tpu_torch/csrc/attention_fwd.cu",
               kern_seed, plain_seed, None, flops,
               (2 * x.numel() + n_par) * sz, err, tol_fwd,
               equals_mask_mode_on_plain_draw=same, kept_fraction=kept,
               **attn_extra("attention_fwd_seed", kern_seed, plain_seed))
        if not (same and err <= tol_fwd):
            raise RuntimeError(f"attention_fwd_seed {dname}: bit-equal to "
                               f"mask mode {same}, |Δ| {err}")

        # backward, seed mode (the training path's), through autograd as a
        # step runs it: dx and the 16 gradients, in the parameters' dtype
        xg = x.detach().requires_grad_()
        pg = {k: v.detach().requires_grad_() for k, v in p.items()}
        inputs = [xg, *[pg[k] for k in PARAM_ORDER]]
        out = fused_attention_layer(xg, pg, HEADS, dropout_p=P_DROP,
                                    seed=seed_t)

        def kern_bwd():
            return torch.autograd.grad(out, inputs, gout, retain_graph=True)

        got1, got2 = kern_bwd(), kern_bwd()
        dxp, gp = attention_layer_backward_reference(x, p, gout, HEADS,
                                                     masks=drawn)
        extra = {}
        if dtype == torch.float32:
            # the mask-mode backward reads the same fp32 values that seed
            # mode draws, so the two agree bit for bit
            via = torch.autograd.grad(
                fused_attention_layer(xg, pg, HEADS, masks=drawn), inputs,
                gout)
            extra["equals_mask_mode_on_plain_draw"] = all(
                torch.equal(a, b) for a, b in zip(got1, via))
        torch.cuda.synchronize()
        names = ("x",) + PARAM_ORDER
        got = dict(zip(names, got1))
        want = {"x": dxp, **gp}
        repeat = all(torch.equal(a, b) for a, b in zip(got1, got2))
        finite = all(torch.isfinite(v.float()).all().item()
                     for v in got.values())
        errs = scaled_errors(torch, got, want)
        err = max((got[k].float() - want[k].float()).abs().max().item()
                  for k in want)
        tol = BWD_TOL[dname]

        def plain_bwd():
            return attention_layer_backward_reference(x, p, gout, HEADS,
                                                      masks=drawn)

        extra.update(attn_extra("attention_bwd", kern_bwd, plain_bwd,
                                backward=True))
        record("attention_bwd", dname,
               "eeg_image_decode_tpu/ops/attention.py:368",
               "eeg_image_decode_tpu_torch/csrc/attention_bwd.cu",
               kern_bwd, plain_bwd, None, 3 * flops,
               (3 * x.numel() + 2 * n_par) * sz,
               err, tol, max_scaled_err=max(errs.values()),
               scaled_err=errs, bit_identical_rerun=repeat, **extra)
        if not (repeat and finite and max(errs.values()) <= tol
                and extra.get("equals_mask_mode_on_plain_draw", True)):
            raise RuntimeError(f"attention_bwd {dname}: rerun bit-equal "
                               f"{repeat}, finite {finite}, errors {errs}, "
                               f"{extra}")

        # tsconv backward through autograd: dx and dw~ in dtype (the
        # kernel's fp32 sums, cast as a step casts them)
        gt = torch.Generator(device="cuda").manual_seed(SEED + 12)
        C, T, K, Fn, pool, stride = 63, 250, 25, 40, 51, 5
        w_tilde = fold_pool_into_kernel(
            torch.randn(K, Fn, generator=gt, device="cuda") * K ** -0.5,
            pool).to(dtype)
        M = w_tilde.shape[0]
        P = out_positions(T, M, stride)
        xt = torch.randn(B, C, T, generator=gt, device="cuda").to(dtype)
        gt_out = torch.randn(B, C, P, Fn, generator=gt,
                             device="cuda").to(dtype)
        m_idx = torch.arange(T, device="cuda")[:, None] - torch.arange(
            P, device="cuda")[None, :] * stride
        valid = (m_idx >= 0) & (m_idx < M)
        e = torch.where(valid[..., None], w_tilde[m_idx.clamp(0, M - 1)],
                        torch.zeros((), dtype=dtype, device="cuda"))
        e = e.reshape(T, P * Fn)
        x2 = xt.reshape(B * C, T)
        g2d = gt_out.reshape(B * C, P * Fn)
        xt_g = xt.detach().requires_grad_()
        w_g = w_tilde.detach().requires_grad_()
        out_t = tsconv_pool_fused(xt_g, w_g, stride)

        def kern_ts():
            return torch.autograd.grad(out_t, [xt_g, w_g], gt_out,
                                       retain_graph=True)

        (a1, b1), (a2, b2) = kern_ts(), kern_ts()
        ap, bp = tsconv_pool_backward_reference(xt, w_tilde, gt_out, stride)
        torch.cuda.synchronize()
        repeat = torch.equal(a1, a2) and torch.equal(b1, b2)
        errs = scaled_errors(torch, {"x": a1, "w_tilde": b1},
                             {"x": ap, "w_tilde": bp})
        err = max((a1.float() - ap).abs().max().item(),
                  (b1.float() - bp).abs().max().item())
        rows_n = B * C
        design = tsconv_backward_design(dtype)
        if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
            raise RuntimeError(f"tsconv_bwd {dname} took design {design}")
        extra = {"design": design,
                 "ragged_case": tsconv_bwd_ragged_check(torch, dtype, tol)}
        if dtype == torch.bfloat16:
            extra["first_version_ms"] = FIRST_VERSION_MS["tsconv_bwd"]
            extra["device_ms"] = device_ms(torch, kern_ts)
            extra["library_device_ms"] = device_ms(
                torch, lambda: (torch.matmul(g2d, e.T),
                                torch.matmul(x2.T, g2d)))
        if a1.dtype != dtype:
            raise RuntimeError(f"tsconv_bwd {dname}: dx arrived as {a1.dtype}")
        record("tsconv_bwd", dname, "eeg_image_decode_tpu/ops/tsconv.py:130",
               "eeg_image_decode_tpu_torch/csrc/tsconv_bwd.cu", kern_ts,
               lambda: tsconv_pool_backward_reference(xt, w_tilde, gt_out,
                                                      stride),
               lambda: (torch.matmul(g2d, e.T), torch.matmul(x2.T, g2d)),
               2 * 2 * rows_n * P * M * Fn,
               (2 * xt.numel() + gt_out.numel() + 2 * w_tilde.numel()) * sz,
               err, tol, max_scaled_err=max(errs.values()), scaled_err=errs,
               bit_identical_rerun=repeat, **extra)
        if not (repeat and max(errs.values()) <= tol):
            raise RuntimeError(f"tsconv_bwd {dname}: rerun bit-equal "
                               f"{repeat}, errors {errs}")

        # tsconv forward at the training shape (64,512 rows)
        def kern_ts_fwd():
            return tsconv_pool_fused(xt, w_tilde, stride)

        got, again = kern_ts_fwd(), kern_ts_fwd()
        want = tsconv_pool_reference(xt, w_tilde, stride)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        tol_f = TOLERANCE[("tsconv_fwd", dname)]
        extra = {"design": forward_design(torch, "tsconv_fwd", dtype)}
        if dtype == torch.bfloat16:
            extra["first_version_ms"] = None
            extra["first_version_note"] = (
                "the first version's bf16 kernel is not in this tree: "
                "scripts/ab_torch_kernels.py times it against this one")
            extra["device_ms"] = device_ms(torch, kern_ts_fwd)
            extra["library_device_ms"] = device_ms(
                torch, lambda: torch.matmul(x2, e))
        record("tsconv_fwd", dname, "eeg_image_decode_tpu/ops/tsconv.py:84",
               "eeg_image_decode_tpu_torch/csrc/tsconv_fwd.cu", kern_ts_fwd,
               lambda: tsconv_pool_reference(xt, w_tilde, stride),
               lambda: torch.matmul(x2, e), 2 * rows_n * P * M * Fn,
               (xt.numel() + w_tilde.numel() + rows_n * P * Fn) * sz, err,
               tol_f, library_desc="dense x2 @ E (the JAX TPU default)",
               key="tsconv_fwd_train", bit_identical_rerun=repeat, **extra)
        if not (repeat and err <= tol_f):
            raise RuntimeError(f"tsconv_fwd {dname}, B {B}: rerun bit-equal "
                               f"{repeat}, |Δ| {err}")
        check_projection_training_kernels(torch, dtype, record)
    return rows


def check_projection_training_kernels(torch, dtype, record) -> None:
    """The projection head's mask-mode and seed-mode forward and its
    backward at B = 1024, one dtype."""
    import torch.nn.functional as F

    from eeg_image_decode_tpu_torch.ops.projection import (
        PARAM_ORDER,
        backward_design,
        draw_keep_mask,
        fused_projection_head,
        projection_head_backward_reference,
        projection_head_reference,
    )

    B = TRAIN_BATCH
    dname = str(dtype).split(".")[-1]
    sz = torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    p = {"wi": randn(D_IN, D_OUT, scale=D_IN ** -0.5),
         "bi": randn(D_OUT, scale=0.1),
         "wr": randn(D_OUT, D_OUT, scale=D_OUT ** -0.5),
         "br": randn(D_OUT, scale=0.1),
         "ln_s": randn(D_OUT, scale=0.1, shift=1.0),
         "ln_b": randn(D_OUT, scale=0.1)}
    p = {k: v.to(dtype) for k, v in p.items()}
    x = randn(B, D_IN).to(dtype)
    gout = randn(B, D_OUT)                               # fp32, as the loss's
    mask = ((torch.rand(B, D_OUT, generator=g, device="cuda") >= P_DROP_PROJ)
            .float() / (1 - P_DROP_PROJ)).to(dtype)
    n_par = sum(v.numel() for v in p.values())
    flops = 2 * B * (D_IN * D_OUT + D_OUT * D_OUT)
    fwd_bytes = (x.numel() + n_par) * sz + B * D_OUT * 4
    replaces_fwd = "eeg_image_decode_tpu/ops/projection.py:94"
    source_fwd = "eeg_image_decode_tpu_torch/csrc/projection_fwd.cu"
    tol_fwd = PROJ_FWD_TOL[dname]
    lib_desc = ("2 matmuls + F.gelu(tanh) + F.dropout + F.layer_norm"
                " (and autograd of it for the backward)")

    def library(xx, pp):
        a = torch.matmul(xx, pp["wi"]) + pp["bi"]
        z = torch.matmul(F.gelu(a, approximate="tanh"), pp["wr"]) + pp["br"]
        z = F.dropout(z, P_DROP_PROJ, training=True)
        return F.layer_norm(a + z, (D_OUT,), pp["ln_s"], pp["ln_b"], 1e-6)

    def fwd_extra(name, kern):
        """The design, and in bf16 the first version's time and the device
        times of the kernel and of the library chain."""
        out = {"design": forward_design(torch, name, dtype)}
        if dtype == torch.bfloat16:
            out["first_version_ms"] = FIRST_VERSION_MS[name]
            out["device_ms"] = device_ms(torch, kern)
            out["library_device_ms"] = device_ms(torch, lambda: library(x, p))
        return out

    def kern_masks():
        return fused_projection_head(x, p, mask)

    def kern_seed():
        return fused_projection_head(x, p, None, P_DROP_PROJ, seed_t)

    # forward, mask mode
    with torch.no_grad():
        got, again = kern_masks(), kern_masks()
        want = projection_head_reference(x, p, mask)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        err = (got - want).abs().max().item()
        record("projection_fwd_masks", dname, replaces_fwd, source_fwd,
               kern_masks, lambda: projection_head_reference(x, p, mask),
               lambda: library(x, p), flops, fwd_bytes + mask.numel() * sz,
               err, tol_fwd, library_desc=lib_desc,
               bit_identical_rerun=repeat,
               **fwd_extra("projection_fwd_masks", kern_masks))
        if not (repeat and err <= tol_fwd and torch.isfinite(got).all()):
            raise RuntimeError(f"projection_fwd_masks {dname}: rerun "
                               f"bit-equal {repeat}, |Δ| {err}")

        # forward, seed mode: bit-equal to mask mode fed the plain draw
        seed = (SEED + 1) % (2**31 - 1)
        seed_t = torch.tensor([seed], dtype=torch.int32, device="cuda")
        drawn = draw_keep_mask(seed, B, D_OUT, P_DROP_PROJ, device="cuda")
        kept = float((drawn > 0).float().mean())
        if abs(kept - (1 - P_DROP_PROJ)) > 0.005:
            raise RuntimeError(f"kept fraction {kept} off 0.5 ± 0.005")
        got, again = kern_seed(), kern_seed()
        via_mask = fused_projection_head(x, p, drawn)
        want = projection_head_reference(x, p, drawn)
        torch.cuda.synchronize()
        same = torch.equal(got, via_mask)
        repeat = torch.equal(got, again)
        err = (got - want).abs().max().item()
        record("projection_fwd_seed", dname, replaces_fwd, source_fwd,
               kern_seed,
               lambda: projection_head_reference(x, p, drawn),
               lambda: library(x, p), flops, fwd_bytes, err, tol_fwd,
               library_desc=lib_desc, equals_mask_mode_on_plain_draw=same,
               kept_fraction=kept, bit_identical_rerun=repeat,
               **fwd_extra("projection_fwd_seed", kern_seed))
        if not (same and repeat and err <= tol_fwd):
            raise RuntimeError(f"projection_fwd_seed {dname}: bit-equal to "
                               f"mask mode {same}, rerun bit-equal {repeat}, "
                               f"|Δ| {err}")

    # backward, seed mode (the training path's), through autograd as a step
    # runs it: dx and the six gradients, in the parameters' dtype
    xg = x.detach().requires_grad_()
    pg = {k: v.detach().requires_grad_() for k, v in p.items()}
    inputs = [xg, *[pg[k] for k in PARAM_ORDER]]
    out = fused_projection_head(xg, pg, None, P_DROP_PROJ, seed_t)

    def kern_bwd():
        return torch.autograd.grad(out, inputs, gout, retain_graph=True)

    got1, got2 = kern_bwd(), kern_bwd()
    via = torch.autograd.grad(fused_projection_head(xg, pg, drawn), inputs,
                              gout)
    dxp, gp = projection_head_backward_reference(x, p, gout, drawn)
    out_lib = library(xg, pg)

    def lib_bwd():
        return torch.autograd.grad(out_lib, inputs, gout, retain_graph=True)

    torch.cuda.synchronize()
    names = ("x",) + PARAM_ORDER
    got = dict(zip(names, got1))
    want = {"x": dxp, **gp}
    repeat = all(torch.equal(a, b) for a, b in zip(got1, got2))
    equals_mask = all(torch.equal(a, b) for a, b in zip(got1, via))
    finite = all(torch.isfinite(v.float()).all().item() for v in got.values())
    errs = {k: (got[k].float() - want[k].float()).abs().max().item()
            / max(want[k].float().abs().max().item(), 1e-30) for k in want}
    err = max((got[k].float() - want[k].float()).abs().max().item()
              for k in want)
    tol = BWD_TOL[dname]
    design = backward_design(dtype)
    if design != ("mma_bf16" if dtype == torch.bfloat16 else "fma_fp32"):
        raise RuntimeError(f"projection_bwd {dname} took design {design}")
    extra = {"design": design}
    if dtype == torch.bfloat16:
        extra["first_version_ms"] = FIRST_VERSION_MS["projection_bwd"]
        extra["device_ms"] = device_ms(torch, kern_bwd)
        extra["library_device_ms"] = device_ms(torch, lib_bwd)
    record("projection_bwd", dname,
           "eeg_image_decode_tpu/ops/projection.py:128",
           "eeg_image_decode_tpu_torch/csrc/projection_bwd.cu", kern_bwd,
           lambda: projection_head_backward_reference(x, p, gout, drawn),
           lib_bwd, 3 * flops,
           (2 * x.numel() + 2 * n_par) * sz + gout.numel() * 4, err, tol,
           library_desc=lib_desc, max_scaled_err=max(errs.values()),
           scaled_err=errs, bit_identical_rerun=repeat,
           equals_mask_mode_on_plain_draw=equals_mask, **extra)
    if not (repeat and finite and max(errs.values()) <= tol
            and (equals_mask or dtype != torch.float32)):
        raise RuntimeError(f"projection_bwd {dname}: rerun bit-equal "
                           f"{repeat}, finite {finite}, equals mask mode "
                           f"{equals_mask}, errors {errs}")


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
                   lambda x, p, h=4, **_: attention_layer_reference(
                       x, cast(p, x), h)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers.tsconv_pool_fused",
                   lambda x, w, s=5, **ep: tsconv_pool_reference(
                       x, w.to(x.dtype), s, **ep)),
        mock.patch("eeg_image_decode_tpu_torch.models.layers."
                   "fused_projection_head",
                   lambda x, p, *_, **__: projection_head_reference(
                       x, cast(p, x))),
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
    svc.warmup((cfg.n_channels, cfg.seq_len))  # this thread's direct calls
    server = EEGDecodeServer(retrieval=svc)
    server.warmup((cfg.n_channels, cfg.seq_len))  # the daemon's device thread
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


# ——— phase 4: the training path ———


def plain_training_ops(torch):
    """The attention layer, tsconv stage 1 and the fused projection head as
    autograd Functions of their plain versions (forward and backward), with
    the wrappers' signatures: the same step without any kernel. In seed mode
    they draw the masks the kernels draw, with ``draw_keep_masks`` and
    ``draw_keep_mask``."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        PARAM_ORDER,
        attention_layer_backward_reference,
        attention_layer_reference,
        draw_keep_masks,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        PARAM_ORDER as PROJ_ORDER,
        draw_keep_mask,
        projection_head_backward_reference,
        projection_head_reference,
    )
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        epilogue_backward,
        tsconv_pool_backward_reference,
        tsconv_pool_reference,
    )

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n_heads, masks, *flat):
            ctx.save_for_backward(x, *flat)
            ctx.n_heads, ctx.masks = n_heads, masks
            return attention_layer_reference(
                x, dict(zip(PARAM_ORDER, flat)), n_heads, masks=masks)

        @staticmethod
        def backward(ctx, g):
            x, *flat = ctx.saved_tensors
            dx, grads = attention_layer_backward_reference(
                x, dict(zip(PARAM_ORDER, flat)), g, ctx.n_heads,
                masks=ctx.masks)
            return (dx, None, None,
                    *[grads[k].to(x.dtype) for k in PARAM_ORDER])

    class PlainTSConv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, stride, scale, shift, elu):
            ctx.save_for_backward(x, w, scale, shift)
            ctx.stride, ctx.elu = stride, elu
            return tsconv_pool_reference(x, w, stride, scale, shift, elu)

        @staticmethod
        def backward(ctx, g):
            x, w, scale, shift = ctx.saved_tensors
            d_scale = d_shift = None
            if scale is not None or shift is not None or ctx.elu:
                g, d_scale, d_shift = epilogue_backward(
                    g, tsconv_pool_reference(x, w, ctx.stride), scale, shift,
                    ctx.elu)
            dx, dw = tsconv_pool_backward_reference(x, w, g, ctx.stride)
            return dx.to(x.dtype), dw.to(w.dtype), None, d_scale, d_shift, \
                None

    class PlainProjection(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mask, *flat):
            ctx.save_for_backward(x, *flat)
            ctx.mask = mask
            return projection_head_reference(
                x, dict(zip(PROJ_ORDER, flat)), mask)

        @staticmethod
        def backward(ctx, g):
            x, *flat = ctx.saved_tensors
            dx, grads = projection_head_backward_reference(
                x, dict(zip(PROJ_ORDER, flat)), g, ctx.mask)
            return (dx, None, *[grads[k].to(x.dtype) for k in PROJ_ORDER])

    def attention(x, params, n_heads=4, *, masks=None, dropout_p=0.0,
                  seed=None, sample0=0):
        dt = x.dtype
        flat = [params[k].to(dt) for k in PARAM_ORDER]
        if masks is not None:  # mask mode reads them in x's dtype
            masks = {k: v.to(dt) for k, v in masks.items()}
        elif dropout_p > 0.0 and seed is not None:  # seed mode: the fp32 draw
            B, L, D = x.shape
            masks = draw_keep_masks(int(seed), B, n_heads, L, D,
                                    params["w1"].shape[1], dropout_p,
                                    row0=sample0, device=x.device)
        return PlainAttention.apply(x, n_heads, masks, *flat)

    def tsconv(x, w_tilde, stride=5, *, scale=None, shift=None, elu=False):
        vec = [None if v is None else v.float().contiguous()
               for v in (scale, shift)]
        return PlainTSConv.apply(x, w_tilde.to(x.dtype), stride, *vec,
                                 bool(elu))

    def projection(x, params, mask=None, dropout_p=0.0, seed=None,
                   sample0=0):
        dt = x.dtype
        flat = [params[k].to(dt) for k in PROJ_ORDER]
        if mask is not None:
            mask = mask.to(dt)
        elif dropout_p > 0.0 and seed is not None:
            mask = draw_keep_mask(int(seed), x.shape[0],
                                  params["wi"].shape[1], dropout_p,
                                  row0=sample0, device=x.device)
        return PlainProjection.apply(x, mask, *flat)

    return [mock.patch("eeg_image_decode_tpu_torch.models.atm_s."
                       "fused_attention_layer", attention),
            mock.patch("eeg_image_decode_tpu_torch.models.layers."
                       "tsconv_pool_fused", tsconv),
            mock.patch("eeg_image_decode_tpu_torch.models.layers."
                       "fused_projection_head", projection)]


#: one training step's gradients, kernels against plain versions, as the
#: relative L2 error per parameter: both round at the same places in bf16,
#: and an fp32 sum that lands on the other side of a bf16 rounding boundary
#: moves an intermediate by 2^-8; 5e-2 is about ten such flips per value
#: on average across a gradient
GRAD_TOL = 5e-2


def grad_rel_l2(got: dict, want: dict) -> dict:
    """Per parameter, ||got − want|| / ||want||; the attention's q/k/v
    biases against the largest of their norms (the key bias's gradient is
    zero in exact arithmetic, so both sides hold rounding there)."""
    norms = {k: v.norm().item() for k, v in want.items()}
    qkv = [k for k in norms if k.split(".")[-2] in ("q_proj", "k_proj",
                                                    "v_proj")
           and k.endswith("bias")]
    bias_scale = max((norms[k] for k in qkv), default=0.0)
    return {k: (got[k] - want[k]).norm().item()
            / max(bias_scale if k in qkv else norms[k], 1e-30)
            for k in want}


def grad_check(torch, trainer, seeded: bool = False) -> dict:
    """The same step through the kernels and through the plain versions:
    the batch and either pinned masks at ATM-S's seven sites, or
    (``seeded``) the trainer's own seed mode with the same generator seed
    on both sides. A pinned ``proj`` mask routes around the fused head, so
    the fused-head model is checked seeded; so is NICE (phase 13), whose
    dropout sites draw from that generator on both sides."""
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.ops.attention import draw_keep_masks
    from eeg_image_decode_tpu_torch.train.contrastive import batch_loss

    model, cfg, data = trainer.model, trainer.cfg, trainer.data
    B = TRAIN_BATCH
    idx = torch.arange(B, device="cuda")
    batch = {"eeg": data.eeg[idx], "subject_ids": data.subject_ids[idx],
             "img_feat": data.img_feat[data.img_idx[idx]],
             "text_feat": data.text_feat[data.text_idx[idx]]}
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def keep(shape, p):
        return (torch.rand(shape, generator=g, device="cuda") >= p).float() \
            / (1.0 - p)

    masks = None if seeded else {
        "emb": keep((B, L_TOK, D_MODEL), 0.25),
        "layer0": draw_keep_masks(SEED + 21, B, HEADS, L_TOK, D_MODEL, D_FF,
                                  0.25, device="cuda"),
        "tsconv": keep((B, 1, 36, 40), 0.5),
        "proj": keep((B, 1024), 0.5)}
    saved = {k: v.clone() for k, v in model.state_dict().items()}

    def step(plain: bool):
        model.load_state_dict(saved)
        model.train()
        model.zero_grad(set_to_none=True)
        with ExitStack() as stack:
            if plain:
                for patch in plain_training_ops(torch):
                    stack.enter_context(patch)
            if seeded:
                gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
                loss, _ = batch_loss(model, cfg, batch, generator=gen)
            else:
                loss, _ = batch_loss(model, cfg, batch, dropout_masks=masks)
            loss.backward()
        return float(loss.detach()), {k: p.grad.detach().float().clone()
                             for k, p in model.named_parameters()}

    _build.reset_launches()
    loss_k, grads_k = step(False)
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    loss_p, grads_p = step(True)
    if any(_build.LAUNCHES.values()):
        raise RuntimeError("the plain step launched a kernel")
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    rel = grad_rel_l2(grads_k, grads_p)
    worst = max(rel, key=rel.get)
    row = {"phase": "train_grad_check", "dtype": "bfloat16",
           "encoder": type(model.encoder).__name__,
           "dropout": "seed mode, one generator seed" if seeded
           else "seven pinned masks",
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "launches_kernel_step": launches, "tolerance": GRAD_TOL,
           "worst_param": worst, "worst_rel_l2": rel[worst],
           "rel_l2": rel}
    emit(row)
    if not (rel[worst] <= GRAD_TOL and np.isfinite(loss_k)):
        raise RuntimeError(f"step gradients, kernels vs plain: {worst} "
                           f"{rel[worst]} > {GRAD_TOL}")
    return row


def train_path(torch, card: str, train, test,
               data_s: float) -> tuple[dict, object]:
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    tcfg = ContrastiveTrainConfig()
    if tcfg.batch_size != TRAIN_BATCH:
        raise RuntimeError(f"batch {tcfg.batch_size} != {TRAIN_BATCH}")
    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device="cuda", seed=SEED)
    trainer = ContrastiveTrainer(model, tcfg, train, test, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    metrics = trainer.train_epoch(0)
    train_launches = dict(_build.LAUNCHES)
    losses = trainer.last_steps["step_loss"]
    step_ms = trainer.last_steps["step_ms"]
    n_steps = len(losses)
    wrong = {k: train_launches[k] for k in
             ("attention_fwd_seed", "attention_bwd", "tsconv_fwd",
              "tsconv_bwd") if train_launches[k] != n_steps}
    if n_steps != train.n // TRAIN_BATCH or wrong:
        raise RuntimeError(f"training launches per step are not 1: {wrong} "
                           f"over {n_steps} steps")
    first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if not (np.all(np.isfinite(losses)) and last8 < first8):
        raise RuntimeError(f"loss did not fall: first 8 {first8}, last 8 "
                           f"{last8}")

    _build.reset_launches()
    t0 = time.perf_counter()
    evaluation = trainer.evaluate(0)                 # reads back: synced
    eval_s = time.perf_counter() - t0
    eval_launches = dict(_build.LAUNCHES)
    if not (eval_launches["attention_fwd"] and eval_launches["tsconv_fwd"]):
        raise RuntimeError(f"evaluation launched no forward kernel: "
                           f"{eval_launches}")
    if not all(np.isfinite(v) for v in evaluation.values()):
        raise RuntimeError(f"non-finite evaluation: {evaluation}")
    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "train", "card": card, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "train_samples": train.n,
           "steps": n_steps, "loss_first8": first8, "loss_last8": last8,
           "epoch_loss": metrics["loss"], "train_acc": metrics["train_acc"],
           "step_ms_p50": p50, "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "samples_per_s": TRAIN_BATCH / (p50 / 1e3),
           "epoch_s": metrics["epoch_time_s"],
           "epoch_samples_per_s": metrics["samples_per_s"],
           "eval_s": eval_s, "data_on_card_s": data_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_train": train_launches,
           "launches_per_step": {k: v / n_steps
                                 for k, v in train_launches.items()},
           "launches_eval": eval_launches, "eval": evaluation,
           "step_loss": losses}
    emit(row)
    return row, trainer


# ——— phase 5: the fused-head joint path, with a checkpoint and a resume ———

TRAIN_KERNELS = ("attention_fwd_seed", "attention_bwd", "tsconv_fwd",
                 "tsconv_bwd", "projection_fwd_seed", "projection_bwd")
#: per-step losses of the resumed epoch against the uninterrupted run's:
#: the restored state is bit-equal, so any difference comes from a
#: PyTorch backward that sums in an order that varies (its index_put);
#: 0.05 is well under one step's change of a loss near 9
RESUME_TOL = 0.05


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def fused_joint_path(torch, card: str, train, test, default_p50: float,
                     main_launches: dict) -> dict:
    from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def with_subjects(split):
        ids = torch.randint(0, 10, (split.n,), generator=g, device="cuda",
                            dtype=torch.int32)
        return dataclasses.replace(split, subject_ids=ids)

    train, test = with_subjects(train), with_subjects(test)
    used = int(torch.unique(train.subject_ids).numel())
    acfg = ATMSConfig(fused_projection=True, joint_train=True)
    tcfg = ContrastiveTrainConfig(ckpt_every_epochs=1)

    def trainer_in(run_dir: str, seed: int) -> ContrastiveTrainer:
        model = build_encoder("atms", config=acfg, dtype=torch.bfloat16,
                              device="cuda", seed=seed)
        return ContrastiveTrainer(
            model, tcfg, train, test, device="cuda", output_dir=run_dir,
            checkpointer=Checkpointer(os.path.join(run_dir, "ckpt")))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as run_dir:
        first = trainer_in(run_dir, SEED)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        history = first.fit(1, log_fn=None)       # epoch 0, eval, checkpoint
        launches = dict(_build.LAUNCHES)
        add_launches(main_launches, launches)
        losses = first.last_steps["step_loss"]
        step_ms = first.last_steps["step_ms"]
        n_steps = len(losses)
        want = {k: n_steps for k in TRAIN_KERNELS}
        want["tsconv_fwd"] += 1                    # the evaluation's
        wrong = {k: launches[k] for k in want if launches[k] != want[k]}
        if wrong or launches["projection_fwd"] != 1 \
                or launches["attention_fwd"] != 1:
            raise RuntimeError(f"fused joint path: launches {launches} over "
                               f"{n_steps} steps and one evaluation")
        first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
        if not (np.all(np.isfinite(losses)) and last8 < first8):
            raise RuntimeError(f"fused joint path: loss did not fall: "
                               f"{first8} -> {last8}")
        if first.checkpointer.all_steps() != [1]:
            raise RuntimeError("no checkpoint after the epoch: "
                               f"{first.checkpointer.all_steps()}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # a fresh model (other weights) and trainer resume and run epoch 1
        resumed = trainer_in(run_dir, SEED + 1)
        t0 = time.perf_counter()
        start = resumed.resume()
        resume_s = time.perf_counter() - t0
        same_state = all(
            torch.equal(a, b) for a, b in zip(
                resumed.model.state_dict().values(),
                first.model.state_dict().values()))
        if start != 1 or not same_state or resumed.state.step != n_steps:
            raise RuntimeError(f"resume: epoch {start}, state restored "
                               f"bit-equal {same_state}, step "
                               f"{resumed.state.step}")
        _build.reset_launches()
        resumed.fit(2, log_fn=None)
        add_launches(main_launches, dict(_build.LAUNCHES))
        if [r["epoch"] for r in resumed.history] != [0, 1]:
            raise RuntimeError(f"resumed history: {resumed.history}")
        got = np.asarray(resumed.last_steps["step_loss"])
        # the uninterrupted run: the first trainer goes on with epoch 1
        first.train_epoch(1)
        ref = np.asarray(first.last_steps["step_loss"])
        delta = float(np.abs(got - ref).max())
        bit_equal = bool(np.array_equal(got, ref))
        if not (np.all(np.isfinite(got)) and delta <= RESUME_TOL):
            raise RuntimeError(f"resumed epoch differs from the "
                               f"uninterrupted one: max |Δloss| {delta}")
        check = grad_check(torch, resumed, seeded=True)
        missing = [k for k in TRAIN_KERNELS
                   if check["launches_kernel_step"][k] != 1]
        if missing:
            raise RuntimeError(f"seeded step launched no {missing}")

    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "train_fused_joint", "card": card, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "subjects_used": used, "steps": n_steps,
           "loss_first8": first8, "loss_last8": last8,
           "epoch_loss": history[0]["loss"], "eval": {
               k: v for k, v in history[0].items() if k.startswith("top")},
           "step_ms_p50": p50, "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "samples_per_s": TRAIN_BATCH / (p50 / 1e3),
           "default_head_step_ms_p50": default_p50,
           "epoch_s": history[0]["epoch_time_s"], "peak_mem_gb": peak_gb,
           "launches_fit_one_epoch": launches,
           "resume_s": resume_s, "resumed_state_bit_equal": same_state,
           "resumed_epoch_max_abs_dloss": delta,
           "resumed_epoch_bit_equal": bit_equal,
           "resume_tolerance": RESUME_TOL,
           "resumed_epoch_loss": float(got.mean())}
    emit(row)
    return row


# ——— phase 6: the training CLI on a written THINGS-EEG-shaped tree ———


def run_cli(argv: list[str]) -> tuple[dict, str | None]:
    """``cli.main(argv)`` in this process: (the JSON row it prints last,
    the run directory it names)."""
    from eeg_image_decode_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    run_dir = next((ln.split(": ", 1)[1] for ln in lines
                    if ln.startswith("run directory: ")), None)
    return json.loads(lines[-1]), run_dir


def cli_path(torch, main_launches: dict,
             tmp: str) -> tuple[dict, str, str, str]:
    """Phase 6 in the directory ``tmp``: (its row, the run directory, the
    tree's root, its feature file)."""
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_things_tree,
    )
    from eeg_image_decode_tpu_torch.ops import _build

    ks, seed = "2,4,10,20", 7
    t0 = time.perf_counter()
    root = os.path.join(tmp, "things")
    feats = write_synthetic_things_tree(
        root, ("sub-01", "sub-02"), n_classes=30, n_test_classes=20,
        seed=SEED)
    tree_s = time.perf_counter() - t0
    common = ["--data-path", root, "--features", feats, "--eval-ks", ks,
              "--subjects", "sub-01"]
    train_args = [*common, "--batch-size", "256", "--seed", str(seed)]
    _build.reset_launches()
    t0 = time.perf_counter()
    row2, run_dir = run_cli(["train-retrieval", *train_args, "--epochs",
                             "2", "--output-dir",
                             os.path.join(tmp, "runs")])
    row3, _ = run_cli(["train-retrieval", *train_args, "--epochs", "3",
                       "--resume-dir", run_dir, "--export-features",
                       os.path.join(tmp, "cli_pairs.npz")])
    # the trainer's evaluation after epoch 2 drew from seed + 104729·2
    scored, _ = run_cli(["evaluate", *common, "--run-dir", run_dir,
                         "--seed", str(seed + 104729 * 2)])
    cli_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    with open(os.path.join(run_dir, "results.csv")) as f:
        csv_rows = len(f.read().splitlines()) - 1
    tops = [k for k in row3 if k.startswith("top")]
    differ = {k: (scored.get(k), row3[k]) for k in tops
              if scored.get(k) != row3[k]}
    missing = [k for k in ("attention_fwd", "attention_fwd_seed",
                           "attention_bwd", "tsconv_fwd", "tsconv_bwd")
               if not launches[k]]
    row = {"phase": "cli", "epochs": [row2["epoch"], row3["epoch"]],
           "loss": [row2["loss"], row3["loss"]], "checkpoints": ckpts,
           "csv_rows": csv_rows, "evaluate": scored,
           "evaluate_equals_trainer": not differ, "launches": launches,
           "write_tree_s": tree_s, "cli_s": cli_s}
    emit(row)
    if (differ or missing or row2["epoch"] != 1 or row3["epoch"] != 2
            or ckpts != ["2", "3"] or csv_rows != 3 or scored["step"] != 3
            or not np.isfinite([row2["loss"], row3["loss"]]).all()):
        raise RuntimeError(f"cli path: evaluate differs {differ}, kernels "
                           f"not launched {missing}, row {row}")
    return row, run_dir, root, feats


# ——— phase 7: CLIP ViT-H/14 features through cli features, and the export ———

#: the THINGS-EEG test split: 200 concepts, one image each
FEATURE_IMAGES = 200
#: bf16 ViT-H/14 features against the port's fp32 features on the same
#: images: per-row cosine at least this (random weights, 32 layers)
FEATURE_COSINE = 0.99
_NOUNS = ("aardvark", "abacus", "accordion", "acorn", "airplane", "alligator",
          "anchor", "ant", "apple", "apron", "axe", "backpack", "bagel",
          "ball", "balloon", "banana", "bandage", "banjo", "barrel", "basket",
          "bat", "bathtub", "battery", "beachball", "bean", "bear", "bed",
          "bee", "beetle", "bell", "belt", "bench", "bicycle", "binoculars",
          "bird", "blender", "boat", "bone", "book", "boot")
_KINDS = ("red", "small", "old", "wooden", "toy")


def vit_h_flops(images: int) -> float:
    """Multiply-adds × 2 of the ViT-H/14 vision forward: patch embedding,
    32 blocks at 257 tokens × 1280 (qkv, scores, weights × values, out,
    the 4× MLP), the 1280 → 1024 projection."""
    n, w, layers = 257, 1280, 32
    block = 2 * n * w * (3 * w + w + 8 * w) + 4 * n * n * w
    return images * (2 * 256 * 588 * w + layers * block + 2 * w * 1024)


def write_image_tree(root: str, n: int, seed: int) -> None:
    """A THINGS-layout tree of ``n`` concept folders ``<NNNNN_concept>/``,
    one 500 × 500 JPEG each (THINGS' size: decode, bicubic resize and crop
    on the host as for real images), of smooth random content."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        concept = f"{_KINDS[i // len(_NOUNS)]}_{_NOUNS[i % len(_NOUNS)]}"
        d = os.path.join(root, f"{i + 1:05d}_{concept}")
        os.makedirs(d)
        low = rng.integers(0, 256, size=(10, 10, 3)).astype(np.float32)
        img = np.kron(low, np.ones((50, 50, 1)))
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(d, f"{concept}_01b.jpg"), quality=90)


def features_path(torch, card: str) -> dict:
    """``cli features`` in this process at ViT-H/14 width in bf16 from
    seeded random weights, on a 200-concept THINGS-layout test tree with the
    49,408-id stand-in vocabulary; then the vision tower's rate at batch 20
    and 256 on device tensors, and the bf16 features against the port's
    fp32 towers on the first 20 images."""
    import pickle

    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.features import (
        CLIPFeatureEncoder,
        clip_cache_path,
        load_features,
        load_image,
    )
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_clip_vocab,
    )
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        things_images_and_prompts,
    )
    from eeg_image_decode_tpu_torch.data.tokenizers import CLIPBPETokenizer
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
        CLIPVisionTower,
        clip_preprocess,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_tree_from_state_dict,
    )

    vcfg, tcfg = CLIPVisionConfig.vit_h_14(), CLIPTextConfig.vit_h_14()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_features_") as tmp:
        t0 = time.perf_counter()
        images = os.path.join(tmp, "test_images")
        write_image_tree(images, FEATURE_IMAGES, SEED)
        paths, prompts = things_images_and_prompts(images)
        vocab, merges = write_synthetic_clip_vocab(tmp, prompts)
        tree_s = time.perf_counter() - t0

        # the fp32 towers, drawn on the card from the seed: the weights of
        # the run (as the --clip-params pickle) and its fp32 reference
        t0 = time.perf_counter()
        with torch.device("cuda"):
            vt32 = CLIPVisionTower(vcfg, seed=SEED).eval()
            tt32 = CLIPTextTower(tcfg, seed=SEED + 1).eval()
        params = {"vision": clip_tree_from_state_dict(
                      vt32.state_dict(), "vision", vcfg.heads),
                  "text": clip_tree_from_state_dict(
                      tt32.state_dict(), "text", tcfg.heads)}
        n_vision = sum(int(p.numel()) for p in vt32.parameters())
        n_params = n_vision + sum(int(p.numel()) for p in tt32.parameters())
        pkl = os.path.join(tmp, "clip_vit_h_14.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(params, f, protocol=pickle.HIGHEST_PROTOCOL)
        del params
        weights_write_s = time.perf_counter() - t0
        pkl_gb = os.path.getsize(pkl) / 1e9

        cache_dir = os.path.join(tmp, "cache")
        argv = ["features", "--images-dir", images, "--clip-params", pkl,
                "--vocab", vocab, "--merges", merges, "--cache-dir",
                cache_dir, "--split", "test", "--batch-size", "20",
                "--device", "cuda"]
        args = cli.build_parser().parse_args(argv)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            enc = args.fn(args)
        cli_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        line = json.loads(buf.getvalue().splitlines()[-1])
        os.remove(pkl)
        stats = dict(enc.stats)
        want_cache = clip_cache_path(cache_dir, "test", paths,
                                     model_name="ViT-H-14", normalize_img=True)
        feats = load_features(line["cache"])
        img, txt = feats["img_features"], feats["text_features"]

        # the rates of the bf16 vision tower on device tensors
        vt = enc.vision_tower
        x20 = clip_preprocess(torch.from_numpy(np.stack(
            [load_image(p, vcfg.image_size) for p in paths[:20]])).cuda())
        x256 = x20.repeat(13, 1, 1, 1)[:256]
        with torch.inference_mode():
            ms20 = cuda_ms(torch, lambda: vt(x20), reps=10)
            ms256 = cuda_ms(torch, lambda: vt(x256), reps=3)
            dev_ms20 = device_ms(torch, lambda: vt(x20), reps=3)
            top20 = top_kernels(torch, lambda: vt(x20))

        # bf16 against the port's fp32 towers, the same weights and images
        ref = CLIPFeatureEncoder(vt32, tt32, CLIPBPETokenizer.from_files(
            vocab, merges), device="cuda")
        img32 = ref.encode_images(paths[:20], batch_size=20)
        txt32 = ref.encode_texts(prompts[:20])
        del ref, vt32, tt32, enc, vt, x20, x256
        torch.cuda.empty_cache()

    def cosines(a, b):
        return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                    * np.linalg.norm(b, axis=-1))

    cos_img, cos_txt = cosines(img[:20], img32), cosines(txt[:20], txt32)
    flops200 = vit_h_flops(FEATURE_IMAGES)
    # bytes: the bf16 weights and the fp32 images read once, the features
    # written once
    bound_ms, bound_by = bound(
        flops200, 2 * n_vision + FEATURE_IMAGES * (224 * 224 * 3 + 1024) * 4,
        "bfloat16")
    row = {"phase": "features", "card": card, "dtype": "bfloat16",
           "model": "ViT-H-14 (seeded random weights)", "params": n_params,
           "images": FEATURE_IMAGES,
           "img_shape": line["img_shape"], "text_shape": line["text_shape"],
           "cache_name_matches": line["cache"] == want_cache,
           "write_tree_s": tree_s, "weights_write_s": weights_write_s,
           "weights_pickle_gb": pkl_gb, "cli_s": cli_s,
           "decode_ms_per_image":
               1e3 * sum(stats["decode_s"]) / stats["images"],
           "decode_s": sum(stats["decode_s"]),
           "device_s": sum(stats["device_s"]),
           # host clock around copy in, tower, copy out: the first batch
           # (first launches of cuBLAS, cuDNN, attention) and the others
           "device_ms_first_batch_host_clock": 1e3 * stats["device_s"][0],
           "device_ms_per_batch_host_clock_p50":
               1e3 * float(np.median(stats["device_s"][1:])),
           "cli_rest_s": (cli_s - sum(stats["decode_s"])
                          - sum(stats["device_s"])),
           "vision_ms_b20": ms20, "vision_device_ms_b20": dev_ms20,
           "vision_top_kernels_b20_device_ms": top20,
           "vision_images_per_s_b20": 20e3 / ms20,
           "vision_ms_b256": ms256, "vision_images_per_s_b256": 256e3 / ms256,
           "vision_tflops_b256": vit_h_flops(256) / ms256 / 1e9,
           "bound_ms_200_images": bound_ms, "bound_by": bound_by,
           "device_ms_200_images_b20": ms20 * FEATURE_IMAGES / 20,
           "peak_device_gb_cli": peak_gb,
           "cosine_bound": FEATURE_COSINE,
           "img_cosine_min": float(cos_img.min()),
           "img_cosine_mean": float(cos_img.mean()),
           "text_cosine_min": float(cos_txt.min()),
           "text_cosine_mean": float(cos_txt.mean())}
    emit(row)
    norms = np.concatenate([np.linalg.norm(img, axis=-1),
                            np.linalg.norm(txt, axis=-1)])
    if not (row["cache_name_matches"]
            and img.shape == (FEATURE_IMAGES, 1024)
            and txt.shape == (FEATURE_IMAGES, 1024)
            and np.isfinite(img).all() and np.isfinite(txt).all()
            and np.abs(norms - 1).max() <= 1e-4
            and cos_img.min() >= FEATURE_COSINE
            and cos_txt.min() >= FEATURE_COSINE):
        raise RuntimeError(f"features path: {row}")
    return row


def export_path(torch, run_dir: str, root: str, feats: str,
                main_launches: dict) -> dict:
    """``cli export-checkpoint`` on phase 6's run, the ``.pth`` back through
    ``convert_atms_state_dict``: the same weights, bit for bit, and the
    same top-5 on the tree's test EEG as the restored run served by
    ``cli serve``'s ``build_retrieval``."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.data.features import load_features
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        build_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import RetrievalService
    from eeg_image_decode_tpu_torch.utils.convert import (
        convert_atms_state_dict,
    )

    pth = os.path.join(os.path.dirname(run_dir), "atms_reference.pth")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export-checkpoint", "--run-dir", run_dir, "--out", pth])
    export_s = time.perf_counter() - t0
    ref_sd = torch.load(pth, weights_only=True)
    served = cli.build_retrieval(cli.build_parser().parse_args(
        ["serve", "--run-dir", run_dir, "--features", feats]))
    model = build_encoder("atms", config=ATMSConfig(), dtype=torch.bfloat16,
                          device="cuda")
    model.load_state_dict(convert_atms_state_dict(ref_sd), strict=True)
    imported = RetrievalService(model, load_features(feats)[
        "img_features_test"], device="cuda")
    same_weights = all(
        torch.equal(a, b) for a, b in zip(
            served.model.state_dict().values(), model.state_dict().values()))
    d = load_features(feats)
    test = build_retrieval_data(
        root, ["sub-01"], train=False, img_features=d["img_features_test"],
        text_features=d["text_features_test"])
    _build.reset_launches()
    _, want = served.top_k(test.eeg, test.subject_ids, k=5)
    _, got = imported.top_k(test.eeg, test.subject_ids, k=5)
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    row = {"phase": "export", "tensors": len(ref_sd), "export_s": export_s,
           "same_weights": same_weights, "rows": int(len(want)),
           "top5_equal": bool(np.array_equal(got, want)),
           "launches": launches}
    emit(row)
    missing = [k for k in ("attention_fwd", "tsconv_fwd") if not launches[k]]
    if not (same_weights and row["top5_equal"]) or missing:
        raise RuntimeError(f"export path: kernels not launched {missing}, "
                           f"row {row}")
    return row


# ——— phase 8: the diffusion prior at full width ———

#: the DDPM sampling of the reference: 50 steps at guidance 5.0
PRIOR_STEPS, PRIOR_GUIDANCE = 50, 5.0
#: a row sampled in another order or another batch against the same row
#: in the full batch: max |Δ| at most this (the products may sum in another
#: order; whether the rows are bit-equal is reported)
REBATCH_TOL = 1e-4


def prior_pairs_path(torch, trainer, main_launches: dict, tmp: str) -> dict:
    """Phase 4's trainer writes the prior's training pairs on the card
    (``export_features``): the eval forward over the 66,160 training and
    200 test rows. Its launches count into the main path."""
    from eeg_image_decode_tpu_torch.ops import _build

    path = os.path.join(tmp, "pairs.npz")
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.export_features(path)
    export_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    with np.load(path) as z:
        pairs = {k: z[k] for k in z.files}
    shapes = {k: list(v.shape) for k, v in pairs.items()}
    if (pairs["eeg_features"].shape != (66160, 1024)
            or pairs["img_features"].shape != (66160, 1024)
            or pairs["eeg_features_test"].shape != (200, 1024)
            or not all(np.isfinite(v).all() for v in pairs.values())
            or not (launches["attention_fwd"] and launches["tsconv_fwd"])):
        raise RuntimeError(f"export_features: {shapes}, launches {launches}")
    emit({"phase": "prior_export", "export_s": export_s, "shapes": shapes,
          "launches": launches})
    return pairs


def prior_path(torch, card: str, pairs: dict, tmp: str) -> dict:
    """``PriorPipe(PriorConfig())`` on the exported pairs: 2 epochs with a
    checkpoint each, a fresh pipe resumed to epoch 3 against an
    uninterrupted 3-epoch run (bit for bit), then CFG sampling of the 200
    test rows and its per-row determinism."""
    from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
    from eeg_image_decode_tpu_torch.core.config import PriorConfig
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    cfg = PriorConfig(seed=SEED % 1000)
    c, h = pairs["eeg_features"], pairs["img_features"]
    n_steps = len(c) // cfg.batch_size
    torch.cuda.reset_peak_memory_stats()
    whole = PriorPipe(cfg, device="cuda")
    h_whole = whole.train(c, h, epochs=3, log_fn=None)
    step_ms = whole.last_steps["step_ms"]
    ref_losses = whole.last_steps["step_loss"].cpu().numpy()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ckpt_dir = os.path.join(tmp, "prior_ckpt")
    part = PriorPipe(cfg, device="cuda")
    part.init(total_steps=n_steps * 3)          # launched as a 3-epoch job
    part.train(c, h, epochs=2, log_fn=None,
               checkpointer=Checkpointer(ckpt_dir), ckpt_every_epochs=1)
    resumed = PriorPipe(cfg, device="cuda")
    t0 = time.perf_counter()
    h_res = resumed.train(c, h, epochs=3, log_fn=None, resume=True,
                          checkpointer=Checkpointer(ckpt_dir))
    resumed_epoch_s = time.perf_counter() - t0
    got = resumed.last_steps["step_loss"].cpu().numpy()
    same_losses = bool(np.array_equal(got, ref_losses))
    same_weights = all(
        torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                          whole.model.state_dict().values()))
    norms = whole.last_steps["grad_norm"].cpu().numpy()
    losses = [r["loss"] for r in h_whole]
    if not (same_losses and same_weights
            and [r["epoch"] for r in h_res] == [0, 1, 2]
            and np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"prior: resumed epoch bit-equal {same_losses}, "
                           f"weights {same_weights}, losses {losses}")

    # sampling: the 200 test rows, 50 steps, guidance 5.0
    test = torch.as_tensor(pairs["eeg_features_test"], device="cuda")
    keys = torch.arange(len(test), dtype=torch.int64, device="cuda") + SEED

    def sample(rows=None):
        sel = slice(None) if rows is None else rows
        return whole.generate(test[sel], num_inference_steps=PRIOR_STEPS,
                              guidance_scale=PRIOR_GUIDANCE,
                              row_keys=keys[sel])

    out = sample()
    sample_ms = cuda_ms(torch, lambda: whole.generate(
        test, num_inference_steps=PRIOR_STEPS,
        guidance_scale=PRIOR_GUIDANCE), reps=5)
    keyed_ms = cuda_ms(torch, sample, reps=3)
    perm = torch.randperm(len(test), generator=torch.Generator().manual_seed(
        SEED)).to("cuda")
    permuted = sample(perm)
    split = torch.cat([sample(slice(0, 37)), sample(slice(37, None))])
    perm_equal = bool(torch.equal(permuted, out[perm]))
    perm_err = float((permuted - out[perm]).abs().max())
    split_equal = bool(torch.equal(split, out))
    split_err = float((split - out).abs().max())
    if not (torch.isfinite(out).all() and out.shape == (len(test),
                                                        cfg.embed_dim)
            and max(perm_err, split_err) <= REBATCH_TOL):
        raise RuntimeError(f"prior sampling: a row differs with its batch: "
                           f"permuted max |Δ| {perm_err}, re-batched "
                           f"{split_err}")

    batch = torch.as_tensor(c[:cfg.batch_size], device="cuda")
    target = torch.as_tensor(h[:cfg.batch_size], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def one_step():
        noise = torch.randn(target.shape, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (len(target),), generator=gen,
                          device="cuda")
        whole.model.train()
        whole._update(whole._loss(target, batch, t, noise,
                                  torch.ones(len(target), device="cuda"),
                                  train=True, generator=gen))

    census = top_kernels(torch, one_step, n=6)
    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "prior", "card": card, "dtype": "float32",
           "params": sum(p.numel() for p in whole.model.parameters()),
           "pairs": len(c), "batch": cfg.batch_size, "steps_per_epoch":
           n_steps, "epoch_loss": losses, "step_ms_p50": p50,
           "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "epoch_s": [r["epoch_time_s"] for r in h_whole],
           "resumed_epoch_s": resumed_epoch_s,
           "resumed_epoch_bit_equal": same_losses,
           "resumed_weights_bit_equal": same_weights,
           "clip_active_steps_last_epoch": int((norms >= 1.0).sum()),
           "grad_norm_last_epoch_min_max": [float(norms.min()),
                                            float(norms.max())],
           "step_launches": census.pop("launches"),
           "step_device_ms": census.pop("all"),
           "step_top_device_ms": census,
           "peak_mem_gb": peak_gb,
           "sample_rows": len(test), "sample_steps": PRIOR_STEPS,
           "guidance": PRIOR_GUIDANCE, "sample_ms": sample_ms,
           "samples_per_s": len(test) / (sample_ms / 1e3),
           "sample_row_keys_ms": keyed_ms,
           "permuted_rows_bit_equal": perm_equal,
           "permuted_max_abs_diff": perm_err,
           "rebatched_rows_bit_equal": split_equal,
           "rebatched_max_abs_diff": split_err,
           "sample_norm_mean": float(out.norm(dim=-1).mean())}
    emit(row)
    return row, whole


def prior_cli_path(torch, pairs_path: str, tmp: str) -> dict:
    """``cli train-prior`` on the pairs phase 6's run exported."""
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    out = os.path.join(tmp, "prior_cli")
    t0 = time.perf_counter()
    last, _ = run_cli(["train-prior", "--eeg-features", pairs_path,
                       "--epochs", "2", "--output-dir", out, "--seed", "7"])
    cli_s = time.perf_counter() - t0
    pipe = PriorPipe.from_checkpoint(os.path.join(out, "diffusion_prior.pkl"))
    with np.load(pairs_path) as z:
        test = torch.as_tensor(z["eeg_features_test"], device="cuda")
    sample = pipe.generate(test, num_inference_steps=10)
    row = {"phase": "prior_cli", "row": last, "cli_s": cli_s,
           "sample_shape": list(sample.shape)}
    emit(row)
    if last["epoch"] != 1 or not np.isfinite(last["loss"]) \
            or not bool(sample.isfinite().all()):
        raise RuntimeError(f"cli train-prior: {row}")
    return row


# ——— phase 9: the low-level VAE-latent trainer at full width ———

def lowlevel_path(torch, card: str, eeg, tmp: str) -> dict:
    """``LowLevelTrainer(LowLevelConfig())`` on phase 4's EEG with per-trial
    latents drawn on the card: two epochs uninterrupted (a checkpoint after
    each), and a fresh trainer resumed from the first epoch's checkpoint,
    whose second epoch must equal the uninterrupted one bit for bit."""
    import shutil

    from eeg_image_decode_tpu_torch.core.checkpoint import Checkpointer
    from eeg_image_decode_tpu_torch.core.config import LowLevelConfig
    from eeg_image_decode_tpu_torch.train.lowlevel import (
        CUDNN_FLAGS,
        LowLevelTrainer,
    )

    cfg = LowLevelConfig(epochs=2)
    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    t0 = time.perf_counter()
    lat = torch.randn((len(eeg), *cfg.latent_shape), generator=g,
                      device="cuda")
    torch.cuda.synchronize()
    latents_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = os.path.join(tmp, "lowlevel_ckpt")
    whole = LowLevelTrainer(cfg, device="cuda")
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": CUDNN_FLAGS["allow_tf32"]}
    h_whole = whole.train(eeg, lat, seed=7, log_fn=None,
                          checkpointer=Checkpointer(ckpt_dir),
                          ckpt_every_epochs=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = whole.last_steps["step_ms"]
    ref = whole.last_steps["step_loss"].cpu().numpy()
    n_steps = len(ref)
    # a fresh trainer resumes from the checkpoint after epoch 1
    first = os.path.join(tmp, "lowlevel_first")
    os.makedirs(first)
    shutil.copytree(os.path.join(ckpt_dir, "1"), os.path.join(first, "1"))
    shutil.copy(os.path.join(ckpt_dir, "history.json"), first)
    resumed = LowLevelTrainer(cfg, device="cuda")
    t0 = time.perf_counter()
    h_res = resumed.train(eeg, lat, seed=7, log_fn=None, resume=True,
                          checkpointer=Checkpointer(first))
    resumed_epoch_s = time.perf_counter() - t0
    got = resumed.last_steps["step_loss"].cpu().numpy()
    same_losses = bool(np.array_equal(got, ref))
    same_weights = all(
        torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                          whole.model.state_dict().values()))
    losses = [r["loss"] for r in h_whole]
    first_k, last_k = float(ref[:50].mean()), float(ref[-50:].mean())
    pred = whole.predict(eeg[:4])
    if not (same_losses and same_weights and n_steps >= 200
            and [r["epoch"] for r in h_res] == [0, 1]
            and np.all(np.isfinite(losses))
            and pred.shape == (4, 64, 64, 4)
            and bool(pred.isfinite().all())):
        raise RuntimeError(f"lowlevel: {n_steps} steps, resumed epoch "
                           f"bit-equal {same_losses}, weights "
                           f"{same_weights}, losses {losses}")

    x, y = eeg[:cfg.batch_size], lat[:cfg.batch_size]

    def one_step():
        whole.model.train()
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            loss = torch.mean(torch.abs(whole.model(x, train=True) - y))
            whole.state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        whole.state.optimizer.step()

    census = top_kernels(torch, one_step)
    p50 = float(np.median(step_ms[3:]))
    row = {"phase": "lowlevel", "card": card, "dtype": "float32",
           "tf32": tf32, "cudnn_deterministic": CUDNN_FLAGS["deterministic"],
           "params": sum(p.numel() for p in whole.model.parameters()),
           "trials": len(eeg), "latents_gb": lat.numel() * 4 / 1e9,
           "latents_on_card_s": latents_s, "batch": cfg.batch_size,
           "steps_per_epoch": n_steps, "epoch_loss": losses,
           "loss_first50_last50_epoch2": [first_k, last_k],
           "step_ms_p50": p50, "step_ms_min": float(np.min(step_ms[3:])),
           "step_ms_max": float(np.max(step_ms[3:])),
           "epoch_s": [r["epoch_time_s"] for r in h_whole],
           "epoch_s_estimate_from_p50": p50 * n_steps / 1e3,
           "resumed_epoch_s": resumed_epoch_s,
           "resumed_epoch_bit_equal": same_losses,
           "resumed_weights_bit_equal": same_weights,
           "step_launches": census.pop("launches"),
           "step_device_ms": census.pop("all"),
           "step_top_device_ms": census,
           "peak_mem_gb": peak_gb}
    emit(row)
    return row


def lowlevel_cli_path(torch, root: str, tmp: str, vae_pkl: str) -> dict:
    """``cli train-lowlevel`` on phase 6's tree: sub-01's training EEG with
    one seeded latent per trial, decoding its previews through the
    full-width SDXL VAE of ``vae_pkl`` after the epoch."""
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        load_things_eeg_subject,
    )

    eeg, _ = load_things_eeg_subject(root, "sub-01", train=True)
    lat = np.random.default_rng(SEED).normal(
        size=(len(eeg), 4, 64, 64)).astype(np.float32)
    path = os.path.join(tmp, "latents.npz")
    np.savez(path, latents=lat)
    out = os.path.join(tmp, "lowlevel_cli")
    previews = os.path.join(tmp, "lowlevel_previews")
    t0 = time.perf_counter()
    last, _ = run_cli(["train-lowlevel", "--data-path", root, "--subjects",
                       "sub-01", "--latents", path, "--epochs", "1",
                       "--output-dir", out, "--preview-dir", previews,
                       "--vae-params", vae_pkl, "--preview-every", "1"])
    shown = sorted(os.listdir(os.path.join(previews, "epoch_0000")))
    row = {"phase": "lowlevel_cli", "trials": len(eeg), "row": last,
           "cli_s": time.perf_counter() - t0,
           "checkpoints": sorted(os.listdir(os.path.join(out, "ckpt"))),
           "previews": shown, "preview_shape": list(
               _png(os.path.join(previews, "epoch_0000", shown[0])).shape)}
    emit(row)
    if last["epoch"] != 0 or not np.isfinite(last["loss"]) \
            or "1" not in row["checkpoints"] or len(shown) != 4 \
            or row["preview_shape"] != [512, 512, 3]:
        raise RuntimeError(f"cli train-lowlevel: {row}")
    return row


def _png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def write_vae_pickle(torch, path: str) -> dict:
    """The full-width SDXL VAE (``VAEConfig.sdxl()``) with seeded N(0, 0.02)
    weights drawn on the card, written as the JAX VAE's param tree of numpy
    arrays: the ``--vae-params`` input of ``cli latents`` and ``cli
    train-lowlevel --preview-dir``."""
    import pickle

    from eeg_image_decode_tpu_torch.gen.sdxl import fill_random_
    from eeg_image_decode_tpu_torch.gen.vae import VAE, VAEConfig
    from eeg_image_decode_tpu_torch.utils.convert import flax_from_params

    t0 = time.perf_counter()
    with torch.device("meta"):
        vae = VAE(VAEConfig.sdxl(), dtype=torch.bfloat16)
    fill_random_(vae.to_empty(device="cuda"), SEED + 7)
    tree = flax_from_params({f"vae.{k}": v
                             for k, v in vae.state_dict().items()})["vae"]
    with open(path, "wb") as f:
        pickle.dump(tree, f, protocol=4)
    return {"params": sum(p.numel() for p in vae.parameters()),
            "pickle_mb": os.path.getsize(path) / 1e6,
            "write_s": time.perf_counter() - t0}


#: ``cli generate`` on phase 6's 20 test concepts: one batch of them
GEN_CLI_BATCH = 20


def generate_cli_path(torch, tmp: str, pairs_path: str, prior_pkl: str,
                      vae_pkl: str) -> dict:
    """``cli latents`` at 512 px on 20 written images (the VAE of
    ``vae_pkl``), then ``cli generate`` at full width on the test features
    of phase 6's run and the prior ``cli train-prior`` wrote: two seeds
    from noise, and one seed from those latents (``--init-latents``,
    strength 0.5)."""
    images = os.path.join(tmp, "gen_images")
    write_image_tree(images, GEN_CLI_BATCH, SEED + 3)
    lat_row, _ = run_cli(["latents", "--images-dir", images, "--vae-params",
                          vae_pkl, "--cache-dir", os.path.join(tmp, "cache"),
                          "--split", "test", "--batch-size", "8"])
    with np.load(lat_row["cache"]) as z:
        lat = z["latents"]
    if (lat_row["latent_shape"] != [GEN_CLI_BATCH, 64, 64, 4]
            or not np.isfinite(lat).all()
            or not os.path.basename(lat_row["cache"]).startswith(
                "sdxl-vae-512_features_test_")):
        raise RuntimeError(f"cli latents: {lat_row}")
    rows = {}
    for name, extra in (("noise", ["--seeds", "2"]),
                        ("init_latents", ["--seeds", "1", "--init-latents",
                                          lat_row["cache"],
                                          "--img2img-strength", "0.5"])):
        out = os.path.join(tmp, f"generated_{name}")
        t0 = time.perf_counter()
        row, _ = run_cli(["generate", "--eeg-features", pairs_path,
                          "--prior-params", prior_pkl, "--gen-batch",
                          str(GEN_CLI_BATCH), "--output-dir", out, *extra])
        row["cli_s"] = time.perf_counter() - t0
        dirs = sorted(os.listdir(out))
        img = _png(os.path.join(out, dirs[-1], "0.png"))
        row["class_dirs"] = len(dirs)
        row["png_shape"] = list(img.shape)
        rows[name] = row
        if (len(dirs) != GEN_CLI_BATCH or row["resolution"] != 512
                or list(img.shape) != [512, 512, 3]):
            raise RuntimeError(f"cli generate ({name}): {row}")
    out = {"phase": "generate_cli", "latents": lat_row, "generate": rows}
    emit(out)
    return out


# ——— phase 10: SDXL-turbo + IP-Adapter generation at full width ———

#: bf16 against fp32 on the same seeded weights: per-row cosine at least
#: this. bf16 keeps 8 bits of mantissa; each of the UNet's 70 transformer
#: blocks and 24 resnets and the VAE's 30 convolutions rounds its input
#: and output once, so the errors add up over the depth but stay far below
#: the signal
GEN_COSINE = 0.99
#: a row served alone against the same (seed, row) coalesced with another
#: request: at most 2/255 in [0, 1] (two 8-bit PNG levels)
GEN_BATCH_TOL = 2 / 255
#: rows per reconstruction chunk (the JAX ``serve --gen-batch`` default)
GEN_BATCH = 16
#: request sizes of the latency table, and requests per size
GEN_SIZES, GEN_REPS = (1, 16, 20), 3


def _post_bytes(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _images(body: bytes) -> np.ndarray:
    with np.load(io.BytesIO(body)) as z:
        return z["images"]


def _row_cosine(torch, a, b) -> list:
    return torch.nn.functional.cosine_similarity(
        a.flatten(1).double(), b.flatten(1).double(), dim=1).tolist()


def _flops(torch, fn) -> float:
    """The multiply-add × 2 operations of one call, from PyTorch's FLOP
    counter (matmuls, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return float(counter.get_total_flops())


def generation_path(torch, card: str, encoder, prior, eeg: np.ndarray,
                    main_launches: dict) -> dict:
    """``sdxl_turbo()`` UNet with the IP-Adapter and the ``sdxl()`` VAE in
    bf16 from the seeded fill; bf16 against fp32 on the same weights (one
    UNet call at B 2, 64 × 64, t = 999, and one VAE decode); then
    ``ReconstructionService`` (phase 4's trained encoder, phase 8's trained
    prior, ``max_batch`` 16, guidance 0, 4 steps, 512 px) behind the HTTP
    daemon: requests of 1, 16 and 20 rows, and two requests the coalescer
    merges, each row held against the same (seed, row) served alone."""
    import threading

    from eeg_image_decode_tpu_torch.gen.sdxl import (
        Generator4Embeds,
        GeneratorConfig,
    )
    from eeg_image_decode_tpu_torch.gen.unet import SDXLUNet
    from eeg_image_decode_tpu_torch.gen.vae import VAE
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import ReconstructionService
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer

    gcfg = GeneratorConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    gen = Generator4Embeds(gcfg, device="cuda")
    gen.init_random(seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = {
        "unet": sum(p.numel() for p in gen.unet.parameters()),
        "unet_ip_adapter": sum(p.numel() for n, p in
                               gen.unet.named_parameters()
                               if "_ip." in n or "image_proj." in n),
        "vae": sum(p.numel() for p in gen.vae.parameters())}
    weights_gb = torch.cuda.memory_allocated() / 1e9 - base_gb

    # bf16 against fp32 on the same weights
    with torch.device("meta"):
        net32 = torch.nn.ModuleDict({
            "unet": SDXLUNet(gcfg.unet, dtype=torch.float32),
            "vae": VAE(gcfg.vae, dtype=torch.float32)})
    net32.to_empty(device="cuda")
    net32.load_state_dict(gen.net.state_dict())
    net32.eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 100)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    lat, ctx, pooled, emb = (randn(2, 4, 64, 64), randn(2, 77, 2048),
                             randn(2, 1280), randn(2, 1024))
    t = torch.full((2,), 999, dtype=torch.int64, device="cuda")
    tids = torch.tensor([[512.0, 512, 0, 0, 512, 512]] * 2, device="cuda")
    with torch.no_grad():
        e16 = gen.unet(lat, t, ctx, pooled, tids, emb)
        e32 = net32["unet"](lat, t, ctx, pooled, tids, emb)
        d16 = gen.vae.decode(lat)
        d32 = net32["vae"].decode(lat)
    precision = {
        "unet_eps_row_cosine": _row_cosine(torch, e16, e32),
        "unet_eps_max_abs_diff": float((e16 - e32).abs().max()),
        "unet_eps_max_abs": float(e32.abs().max()),
        "vae_decode_row_cosine": _row_cosine(torch, d16, d32),
        "vae_decode_max_abs_diff": float((d16 - d32).abs().max()),
        "vae_decode_max_abs": float(d32.abs().max()),
        "cosine_limit": GEN_COSINE}
    del net32, e32, d32
    torch.cuda.empty_cache()
    if not (torch.isfinite(e16).all() and torch.isfinite(d16).all()
            and min(precision["unet_eps_row_cosine"]
                    + precision["vae_decode_row_cosine"]) >= GEN_COSINE):
        raise RuntimeError(f"generation bf16 against fp32: {precision}")

    # the stages alone at B 16: device time and operations
    x16 = randn(GEN_BATCH, 4, 64, 64)
    t16 = torch.full((GEN_BATCH,), 999, dtype=torch.int64, device="cuda")
    ctx16 = torch.zeros(GEN_BATCH, 77, 2048, device="cuda")
    tids16 = tids[:1].expand(GEN_BATCH, -1)
    emb16 = randn(GEN_BATCH, 1024)

    def unet_call():
        with torch.no_grad():
            gen.unet(x16, t16, ctx16, None, tids16, emb16)

    def decode_call():
        with torch.no_grad():
            gen.vae.decode(x16)

    stages = {
        "unet_ms_b16": cuda_ms(torch, unet_call, reps=5),
        "vae_decode_ms_b16": cuda_ms(torch, decode_call, reps=3),
        "unet_flops_per_image": _flops(torch, lambda: gen.unet(
            x16[:1], t16[:1], ctx16[:1], None, tids16[:1], emb16[:1])),
        "vae_decode_flops_per_image": _flops(
            torch, lambda: gen.vae.decode(x16[:1]))}
    for k in ("unet", "vae_decode"):
        stages[f"{k}_tflops_per_s"] = (
            GEN_BATCH * stages[f"{k}_flops_per_image"]
            / (stages[f"{k}_ms_b16"] / 1e3) / 1e12)
    stages["unet_top_device_ms_b16"] = top_kernels(torch, unet_call, n=6)
    stages["vae_decode_top_device_ms_b16"] = top_kernels(torch, decode_call,
                                                         n=6)

    svc = ReconstructionService(encoder, prior, gen, max_batch=GEN_BATCH,
                                device="cuda")
    server = EEGDecodeServer(reconstruction=svc)
    t0 = time.perf_counter()
    server.warmup((eeg.shape[1], eeg.shape[2]))  # on its device thread
    warmup_s = time.perf_counter() - t0
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}/v1/reconstruct"

    def body(lo, n, seed):
        return _npz(eeg=eeg[lo:lo + n], subject_ids=np.zeros(n, np.int32),
                    seed=np.int64(seed))

    try:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        latency, answers = {}, {}
        for n in GEN_SIZES:
            times = []
            for _ in range(GEN_REPS):
                t0 = time.perf_counter()
                answers[n] = _images(_post_bytes(url, body(0, n, SEED)))
                times.append(time.perf_counter() - t0)
            p50 = float(np.median(times))
            latency[str(n)] = {"http_p50_s": p50,
                               "http_min_s": float(np.min(times)),
                               "images_per_s": n / p50}
        launches = dict(_build.LAUNCHES)
        for n in GEN_SIZES:  # the service called directly: no HTTP
            times = []
            for _ in range(GEN_REPS):
                t0 = time.perf_counter()
                svc.reconstruct(eeg[:n], np.zeros(n, np.int32), seed=SEED)
                times.append(time.perf_counter() - t0)
            latency[str(n)]["direct_p50_s"] = float(np.median(times))
        t0 = time.perf_counter()
        wire = _npz(images=answers[16])
        t1 = time.perf_counter()
        _images(wire)
        wire_s = {"npz_write_16_s": t1 - t0,
                  "npz_read_16_s": time.perf_counter() - t1,
                  "npz_mb_16": len(wire) / 1e6}
        add_launches(main_launches, launches)
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for n, imgs in answers.items():
            if (imgs.shape != (n, 512, 512, 3) or imgs.dtype != np.float32
                    or not np.isfinite(imgs).all() or imgs.min() < 0
                    or imgs.max() > 1):
                raise RuntimeError(f"reconstruct {n} rows: shape "
                                   f"{imgs.shape}, range [{imgs.min()}, "
                                   f"{imgs.max()}]")
        if not (launches["attention_fwd"] and launches["tsconv_fwd"]):
            raise RuntimeError(f"the reconstruction path launched no "
                               f"forward kernel: {launches}")

        # the same (seed, row) in a 1-row, a 16-row and a 20-row request
        one_vs_16 = float(np.abs(answers[1] - answers[16][:1]).max())
        sixteen_vs_20 = float(np.abs(answers[16] - answers[20][:16]).max())

        # two requests the coalescer merges: both are pending when the
        # device lock is released, so one dispatch serves their 8 rows
        results = {}
        pending = server._coalescers["reconstruction"]

        def client(name, lo, n, seed):
            results[name] = _images(_post_bytes(url, body(lo, n, seed)))

        threads = [threading.Thread(target=client, args=a) for a in
                   (("a", 0, 3, SEED + 1), ("b", 3, 5, SEED + 2))]
        with server._device_lock:
            for th in threads:
                th.start()
            deadline = time.perf_counter() + 120
            while len(pending._pending) < 2:
                if time.perf_counter() > deadline:
                    raise RuntimeError("the two requests never queued")
                time.sleep(0.01)
        for th in threads:
            th.join(timeout=600)
        alone = {"a": svc.reconstruct(eeg[0:3], np.zeros(3, np.int32),
                                      seed=SEED + 1),
                 "b": svc.reconstruct(eeg[3:8], np.zeros(5, np.int32),
                                      seed=SEED + 2)}
        coalesced_err = max(float(np.abs(results[k] - alone[k]).max())
                            for k in alone)
        coalesced_bit_equal = all(np.array_equal(results[k], alone[k])
                                  for k in alone)
        if max(coalesced_err, one_vs_16, sixteen_vs_20) > GEN_BATCH_TOL:
            raise RuntimeError(
                f"a row's image depends on its batch: coalesced max |Δ| "
                f"{coalesced_err}, 1 vs 16 rows {one_vs_16}, 16 vs 20 "
                f"{sixteen_vs_20}")

        # the device split of a 16-row request (CUDA events per stage)
        direct, splits = [], []
        for _ in range(GEN_REPS):
            t0 = time.perf_counter()
            svc.reconstruct(eeg[:GEN_BATCH], np.zeros(GEN_BATCH, np.int32),
                            seed=SEED)
            direct.append(time.perf_counter() - t0)
            splits.append(dict(svc.stage_ms))
        split = {k: float(np.median([s[k] for s in splits]))
                 for k in svc.STAGES}
        # the device's busy time in one traced 16-row request
        census = top_kernels(torch, lambda: svc.reconstruct(
            eeg[:GEN_BATCH], np.zeros(GEN_BATCH, np.int32), seed=SEED), n=6)
        busy_ms, launches_16 = census.pop("all"), census.pop("launches")
    finally:
        server.stop()

    row = {"phase": "generation", "card": card, "dtype": "bfloat16",
           "params": counts, "weights_gb": weights_gb,
           "build_s": build_s, "precision": precision, "stages": stages,
           "max_batch": GEN_BATCH,
           "steps": gcfg.num_inference_steps,
           "guidance": gcfg.guidance_scale, "resolution": 512,
           "prior_steps": prior.cfg.num_inference_steps,
           "prior_guidance": prior.cfg.guidance_scale,
           "warmup_s": warmup_s, "latency": latency, "wire": wire_s,
           "direct_p50_s_16": float(np.median(direct)),
           "device_ms_16": split,
           "device_ms_16_total": float(sum(split.values())),
           "launches_16": launches_16, "device_busy_ms_16": busy_ms,
           "idle_share_16": 1.0 - busy_ms / (float(np.median(direct)) * 1e3),
           "top_device_ms_16": census,
           "launches": launches,
           "one_vs_16_rows_max_abs_diff": one_vs_16,
           "sixteen_vs_20_rows_max_abs_diff": sixteen_vs_20,
           "coalesced_max_abs_diff": coalesced_err,
           "coalesced_bit_equal": coalesced_bit_equal,
           "batch_tolerance": GEN_BATCH_TOL,
           "serve_peak_mem_gb": serve_peak_gb}
    emit(row)
    return row


# ——— phase 6, captioning: cli train-adapter, cli caption, cli serve ———

#: images of ``cli train-adapter --images-dir`` (at least one batch of 32)
ADAPTER_CLI_IMAGES = 40


def caption_cli_path(torch, tmp: str, pairs_path: str, prior_pkl: str,
                     feats: str) -> dict:
    """``cli train-adapter --images-dir`` on 40 written JPEGs through a
    seeded ``git_vit_l_14`` pickle (bf16 grids into the JAX cache file),
    then ``cli caption --eeg-features`` on phase 6's exported test features
    and the ``train-prior`` pickle through a seeded full-width GIT pickle,
    the trained projector and the 30,522-id stand-in vocabulary (20
    lines), then ``cli serve --git-params`` once: the daemon it builds
    answers one ``/v1/caption`` request and stops."""
    import pickle

    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_wordpiece_vocab,
    )
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from eeg_image_decode_tpu_torch.models.git_caption import (
        GITCaptioner,
        GITConfig,
    )
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer
    from eeg_image_decode_tpu_torch.utils.convert import (
        git_tree_from_state_dict,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_tree_from_state_dict,
    )

    t0 = time.perf_counter()
    images = os.path.join(tmp, "adapter_images")
    write_image_tree(images, ADAPTER_CLI_IMAGES, SEED + 5)
    emb = np.random.default_rng(SEED + 5).normal(
        size=(ADAPTER_CLI_IMAGES, 1024)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb_path = os.path.join(tmp, "adapter_embeds.npz")
    np.savez(emb_path, img_features=emb)
    vcfg = CLIPVisionConfig.git_vit_l_14()
    with torch.device("cuda"):
        tower = CLIPVisionTower(vcfg, seed=SEED + 6)
    vision_pkl = os.path.join(tmp, "git_vit_l_14.pkl")
    with open(vision_pkl, "wb") as f:
        pickle.dump(clip_tree_from_state_dict(tower.state_dict(), "vision",
                                              vcfg.heads), f, protocol=4)
    del tower
    gcfg = GITConfig.git_large_coco()
    with torch.device("cuda"):
        git = GITCaptioner(gcfg).init_random(SEED + 8)
    git_pkl = os.path.join(tmp, "git_large_coco.pkl")
    with open(git_pkl, "wb") as f:
        pickle.dump(git_tree_from_state_dict(git.state_dict(), gcfg.n_heads),
                    f, protocol=4)
    del git
    vocab = write_synthetic_wordpiece_vocab(os.path.join(tmp, "wordpiece"))
    write_s = time.perf_counter() - t0

    cache = os.path.join(tmp, "grid_cache")
    proj_pkl = os.path.join(tmp, "pixel_projector.pkl")
    t0 = time.perf_counter()
    adapter, _ = run_cli(["train-adapter", "--embeddings", emb_path,
                          "--images-dir", images, "--git-vision-params",
                          vision_pkl, "--test-embeddings", emb_path,
                          "--test-images-dir", images, "--cache-dir", cache,
                          "--epochs", "2", "--batch-size", "8", "--out",
                          proj_pkl])
    adapter_s = time.perf_counter() - t0
    names = sorted(os.listdir(cache))
    with np.load(os.path.join(cache, names[-1])) as z:
        grids = z["grids"]
    if (len(names) != 2 or not all(n.startswith("ViT-L-14-GIT-grid_features_")
                                   for n in names)
            or grids.shape != (ADAPTER_CLI_IMAGES, 257, 1024)
            or not np.isfinite(grids).all()
            or not np.isfinite([adapter["final_train_loss"],
                                adapter["test_mse"]]).all()):
        raise RuntimeError(f"cli train-adapter: {adapter}, cache {names}, "
                           f"grids {grids.shape}")

    out = os.path.join(tmp, "semantic_level_caption.txt")
    t0 = time.perf_counter()
    caption, _ = run_cli(["caption", "--eeg-features", pairs_path,
                          "--prior-params", prior_pkl, "--git-params",
                          git_pkl, "--projector-params", proj_pkl,
                          "--vocab", vocab, "--out", out])
    caption_s = time.perf_counter() - t0
    with open(out) as f:
        lines = f.read().splitlines()
    with np.load(pairs_path) as z:
        n_test = len(z["eeg_features_test"])
    if len(lines) != n_test or caption["captions"] != n_test:
        raise RuntimeError(f"cli caption: {len(lines)} lines for {n_test} "
                           f"test rows: {caption}")

    served = {}

    def serve_once(server, host="127.0.0.1", port=8080):
        port = server.start(host=host, port=0)
        eeg = np.random.default_rng(SEED + 9).normal(
            size=(2, 63, 250)).astype(np.float32)
        try:
            served.update(_post(
                f"http://127.0.0.1:{port}/v1/caption",
                _npz(eeg=eeg, subject_ids=np.zeros(2, np.int32),
                     seed=np.int64(SEED)), "application/octet-stream"))
        finally:
            server.stop()

    t0 = time.perf_counter()
    with mock.patch.object(EEGDecodeServer, "serve_forever", serve_once), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(["serve", "--features", feats, "--prior-params", prior_pkl,
                  "--git-params", git_pkl, "--projector-params", proj_pkl,
                  "--vocab", vocab])
    serve_s = time.perf_counter() - t0
    if len(served.get("captions", [])) != 2:
        raise RuntimeError(f"cli serve --git-params answered {served}")
    row = {"phase": "caption_cli", "train_adapter": adapter,
           "grid_caches": names, "caption": caption,
           "caption_lines": len(lines), "first_caption": lines[0][:120],
           "serve_captions": [c[:120] for c in served["captions"]],
           "write_s": write_s, "train_adapter_s": adapter_s,
           "caption_s": caption_s, "serve_s": serve_s}
    emit(row)
    return row


# ——— phase 11: GIT captioning at full width ———

#: rows per caption chunk (the JAX ``serve --gen-batch`` default)
CAPTION_BATCH = 16
#: request sizes of the latency table, and requests per size
CAPTION_SIZES, CAPTION_REPS = (1, 16, 20), 3
#: the adapter's full-size split: THINGS' 16,540 training images
ADAPTER_IMAGES = 16540


def _tokens_gap(torch, svc, emb_row, tokens_row, step: int) -> float:
    """The top-2 logit gap of one row at decode step ``step`` (the
    position ``step - 1`` of its prefix), from its prior embedding."""
    with torch.inference_mode():
        vis = svc.projector(torch.as_tensor(emb_row[None]).cuda())
        ids = torch.as_tensor(tokens_row[None, :step]).cuda()
        top = torch.topk(svc.captioner(vis, ids)[0, step - 1], 2).values
    return float(top[0] - top[1])


def _prior_embeds(torch, svc, eeg, sids, *, seed=0, row_seeds=None
                  ) -> np.ndarray:
    """The prior's CLIP embeddings the service conditions its captions on,
    chunked and padded as its ``tokens`` chunks them."""
    from eeg_image_decode_tpu_torch.serve import (
        _padded_chunks,
        _prior_embeddings,
    )

    out = []
    with torch.inference_mode():
        for chunk, m in _padded_chunks(eeg, sids, row_seeds, seed,
                                       svc.max_batch):
            out.append(_prior_embeddings(svc.model, svc.prior, *chunk,
                                         svc.device, [[]])[:m])
    return torch.cat(out).cpu().numpy()


def caption_path(torch, card: str, encoder, prior, eeg: np.ndarray,
                 main_launches: dict) -> dict:
    """``GITConfig.git_large_coco()`` and a full-width ``PixelProjector`` in
    fp32 from the seeded init on the card; one decoder forward and one
    greedy decode alone at B 16; then ``CaptionService`` (phase 4's trained
    encoder, phase 8's trained prior, ``max_batch`` 16, 25 new tokens, the
    30,522-id stand-in vocabulary) behind the HTTP daemon: requests of 1,
    16 and 20 rows, two requests the coalescer merges, and the prior
    embeddings against ``ReconstructionService``'s."""
    import threading

    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_wordpiece_vocab,
    )
    from eeg_image_decode_tpu_torch.data.tokenizers import WordPieceTokenizer
    from eeg_image_decode_tpu_torch.models.git_caption import (
        GITCaptioner,
        GITConfig,
        PixelProjector,
    )
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.serve import (
        CaptionService,
        ReconstructionService,
        _default_row_seeds,
    )
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer

    gcfg = GITConfig.git_large_coco()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    with torch.device("cuda"):
        git = GITCaptioner(gcfg).init_random(SEED).eval()
        proj = PixelProjector(gcfg.num_visual_tokens, prior.cfg.embed_dim,
                              gcfg.visual_dim).init_random(SEED + 1).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = {"git": sum(p.numel() for p in git.parameters()),
              "git_blocks": sum(p.numel() for p in
                                git.git.encoder.parameters()),
              "projector": sum(p.numel() for p in proj.parameters())}
    weights_gb = torch.cuda.memory_allocated() / 1e9 - base_gb

    # the stages alone at B 16: 257 visual + 26 text tokens, 25 new tokens
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    emb = torch.randn(CAPTION_BATCH, prior.cfg.embed_dim, generator=g,
                      device="cuda")
    emb = emb / emb.norm(dim=1, keepdim=True)
    buf = min(gcfg.max_text_len, 25 + 1)
    ids = torch.randint(0, gcfg.vocab_size, (CAPTION_BATCH, buf),
                        generator=g, device="cuda")
    with torch.inference_mode():
        vis = proj(emb)

    def forward():
        with torch.inference_mode():
            git(vis, ids)

    def decode():
        git.generate(vis, max_new_tokens=25)

    stages = {"forward_ms_b16": cuda_ms(torch, forward, reps=5),
              "decode_ms_b16": cuda_ms(torch, decode, reps=3),
              "forward_flops_b16": _flops(torch, forward),
              "decode_flops_b16": _flops(torch, decode)}
    for k in ("forward", "decode"):
        stages[f"{k}_tflops_per_s"] = (stages[f"{k}_flops_b16"]
                                       / (stages[f"{k}_ms_b16"] / 1e3) / 1e12)
        stages[f"{k}_fp32_bound_ms"] = (stages[f"{k}_flops_b16"]
                                        / PEAK_FLOPS["float32"] * 1e3)
    stages["forward_top_device_ms_b16"] = top_kernels(torch, forward, n=6)
    stages["decode_top_device_ms_b16"] = top_kernels(torch, decode, n=6)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_caption_") as tmp:
        tok = WordPieceTokenizer.from_file(write_synthetic_wordpiece_vocab(
            tmp))
    svc = CaptionService(encoder, prior, git, proj, tok,
                         max_batch=CAPTION_BATCH, max_new_tokens=25,
                         device="cuda")
    server = EEGDecodeServer(caption=svc)
    t0 = time.perf_counter()
    server.warmup((eeg.shape[1], eeg.shape[2]))  # on its device thread
    warmup_s = time.perf_counter() - t0
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}/v1/caption"
    sids = np.zeros(len(eeg), np.int32)

    def request(lo, n, seed):
        return _post(url, _npz(eeg=eeg[lo:lo + n], subject_ids=sids[:n],
                               seed=np.int64(seed)),
                     "application/octet-stream")["captions"]

    try:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        latency, answers = {}, {}
        for n in CAPTION_SIZES:
            times = []
            for _ in range(CAPTION_REPS):
                t0 = time.perf_counter()
                answers[n] = request(0, n, SEED)
                times.append(time.perf_counter() - t0)
            p50 = float(np.median(times))
            latency[str(n)] = {"http_p50_s": p50,
                               "http_min_s": float(np.min(times)),
                               "captions_per_s": n / p50}
        launches = dict(_build.LAUNCHES)
        add_launches(main_launches, launches)
        if not (launches["attention_fwd"] and launches["tsconv_fwd"]):
            raise RuntimeError(f"the caption path launched no forward "
                               f"kernel: {launches}")

        # the same (seed, row) at the same offset in every request size
        tokens = {}
        for n in CAPTION_SIZES:  # the service called directly: no HTTP
            t0 = time.perf_counter()
            tokens[n] = svc.tokens(eeg[:n], sids[:n], seed=SEED)
            latency[str(n)]["direct_s"] = time.perf_counter() - t0
            if answers[n] != [tok.decode(r) for r in tokens[n]]:
                raise RuntimeError(f"{n}-row request: HTTP captions differ "
                                   "from the service's ids")
        same_offset = (np.array_equal(tokens[1], tokens[16][:1])
                       and np.array_equal(tokens[16], tokens[20][:16]))
        if not same_offset:
            raise RuntimeError("a (seed, row) gave other token ids at the "
                               "same offset in another request size")
        if (tokens[20].shape != (20, 26) or (tokens[20][:, 0]
                                             != gcfg.bos_token_id).any()):
            raise RuntimeError(f"token ids {tokens[20].shape}")

        # the prior's embeddings: the reconstruction service's for the
        # same (seed, row) (its generator stage handing them back)
        class _Echo:
            def generate(self, embeds, decode=False, row_keys=None):
                return embeds

            def decode(self, latents):
                return latents

        recon = ReconstructionService(encoder, prior, _Echo(),
                                      max_batch=CAPTION_BATCH, device="cuda")
        emb20 = _prior_embeds(torch, svc, eeg[:20], sids[:20], seed=SEED)
        prior_vs_recon = float(np.abs(
            emb20 - recon.reconstruct(eeg[:20], sids[:20], seed=SEED)).max())
        if prior_vs_recon > REBATCH_TOL:
            raise RuntimeError(f"caption and reconstruction priors differ "
                               f"by {prior_vs_recon}")

        # two requests the coalescer merges (rows at other offsets)
        results = {}
        pending = server._coalescers["caption"]

        def client(name, lo, n, seed):
            results[name] = request(lo, n, seed)

        threads = [threading.Thread(target=client, args=a) for a in
                   (("a", 0, 3, SEED + 1), ("b", 3, 5, SEED + 2))]
        with server._device_lock:
            for th in threads:
                th.start()
            deadline = time.perf_counter() + 120
            while len(pending._pending) < 2:
                if time.perf_counter() > deadline:
                    raise RuntimeError("the two requests never queued")
                time.sleep(0.01)
            # the merged batch takes the queue's order
            order = [int(it["rows"]["row_seeds"][0, 0])
                     for it in pending._pending]
        for th in threads:
            th.join(timeout=600)
        spans = {SEED + 1: ("a", 0, 3), SEED + 2: ("b", 3, 5)}
        merged = [spans[seed] + (seed,) for seed in order]
        rows = np.concatenate([np.arange(lo, lo + n)
                               for _, lo, n, _ in merged])
        merged_rs = np.concatenate([_default_row_seeds(n, seed)
                                    for _, _, n, seed in merged])
        merged_tok = svc.tokens(eeg[rows], sids[rows], row_seeds=merged_rs)
        merged_emb = _prior_embeds(torch, svc, eeg[rows], sids[rows],
                                   row_seeds=merged_rs)
        agree, differ, emb_diff, at = 0, [], 0.0, 0
        for name, lo, n, seed in merged:
            got_tok, got_emb = merged_tok[at:at + n], merged_emb[at:at + n]
            at += n
            if results[name] != [tok.decode(r) for r in got_tok]:
                raise RuntimeError(f"coalesced request {name}: HTTP "
                                   "captions differ from the merged ids")
            alone_tok = svc.tokens(eeg[lo:lo + n], sids[:n], seed=seed)
            alone_emb = _prior_embeds(torch, svc, eeg[lo:lo + n], sids[:n],
                                      seed=seed)
            emb_diff = max(emb_diff, float(np.abs(alone_emb
                                                  - got_emb).max()))
            for j in range(n):
                a, b = alone_tok[j], got_tok[j]
                if np.array_equal(a, b):
                    agree += 1
                    continue
                step = int(np.nonzero(a != b)[0][0])
                differ.append({
                    "request": name, "row": j, "first_step": step,
                    "embed_max_abs_diff": float(np.abs(
                        alone_emb[j] - got_emb[j]).max()),
                    "top2_gap_alone": _tokens_gap(torch, svc, alone_emb[j],
                                                  a, step),
                    "top2_gap_merged": _tokens_gap(torch, svc, got_emb[j],
                                                   b, step)})

        # the device split of a 16-row request (CUDA events per stage)
        direct, splits = [], []
        for _ in range(CAPTION_REPS):
            t0 = time.perf_counter()
            svc.tokens(eeg[:CAPTION_BATCH], sids[:CAPTION_BATCH], seed=SEED)
            direct.append(time.perf_counter() - t0)
            splits.append(dict(svc.stage_ms))
        split = {k: float(np.median([s[k] for s in splits]))
                 for k in svc.STAGES}
        census = top_kernels(torch, lambda: svc.tokens(
            eeg[:CAPTION_BATCH], sids[:CAPTION_BATCH], seed=SEED), n=6)
        busy_ms, launches_16 = census.pop("all"), census.pop("launches")
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        server.stop()

    row = {"phase": "caption", "card": card, "dtype": "float32",
           "params": counts, "weights_gb": weights_gb, "build_s": build_s,
           "stages": stages, "max_batch": CAPTION_BATCH,
           "max_new_tokens": 25, "vocab": len(tok.vocab),
           "prior_steps": prior.cfg.num_inference_steps,
           "prior_guidance": prior.cfg.guidance_scale,
           "warmup_s": warmup_s, "latency": latency,
           "direct_p50_s_16": float(np.median(direct)),
           "device_ms_16": split,
           "device_ms_16_total": float(sum(split.values())),
           "launches_16": launches_16, "device_busy_ms_16": busy_ms,
           "idle_share_16": 1.0 - busy_ms / (float(np.median(direct)) * 1e3),
           "top_device_ms_16": census, "launches": launches,
           "same_offset_ids_equal": same_offset,
           "prior_vs_reconstruction_max_abs_diff": prior_vs_recon,
           "coalesced_order": [name for name, *_ in merged],
           "coalesced_rows_agree": agree, "coalesced_rows": 8,
           "coalesced_embed_max_abs_diff": emb_diff,
           "coalesced_differ": differ,
           "first_captions": [c[:120] for c in answers[16][:2]],
           "serve_peak_mem_gb": serve_peak_gb}
    emit(row)
    return row


def adapter_path(torch, card: str) -> dict:
    """``train_pixel_projector`` at full width for one epoch: 16,540 unit
    1024-d embeddings and 16,540 × 257 × 1024 fp32 grids (17.4 GB) drawn
    on the card from ``SEED`` (each grid token a fixed squashing of its
    embedding's channels plus noise: a target the adapter can learn),
    batch 32, bf16 products; the loss finite and falling: the MSE of the
    first 1,024 rows under the trained projector below that of its seeded
    init. The step time is the epoch's CUDA-event time over its steps."""
    from eeg_image_decode_tpu_torch.train.adapters import (
        AdapterTrainConfig,
        evaluate_pixel_projector,
        init_pixel_projector,
        train_pixel_projector,
    )

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 300)
    x = torch.randn(ADAPTER_IMAGES, 1024, generator=g, device="cuda")
    x /= x.norm(dim=1, keepdim=True)
    scale = torch.randn(257, 1, generator=g, device="cuda") * 32
    shift = torch.randn(257, 1024, generator=g, device="cuda") * 0.1
    y = torch.empty(ADAPTER_IMAGES, 257, 1024, device="cuda")
    for lo in range(0, ADAPTER_IMAGES, 1024):
        c = y[lo:lo + 1024]
        torch.tanh(x[lo:lo + 1024, None, :] * scale + shift, out=c)
        c.add_(torch.randn(c.shape, generator=g, device="cuda"), alpha=0.1)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    cfg = AdapterTrainConfig(epochs=1, seed=SEED)
    init = init_pixel_projector(257, 1024, 1024, seed=cfg.seed,
                                dtype=torch.bfloat16,
                                device=torch.device("cuda")).eval()
    mse_init = evaluate_pixel_projector(init, x[:1024], y[:1024])
    del init
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    proj, losses = train_pixel_projector(x, y, cfg, device="cuda")
    ev[1].record()
    epoch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    steps = ADAPTER_IMAGES // cfg.batch_size
    mse_trained = evaluate_pixel_projector(proj, x[:1024], y[:1024])
    row = {"phase": "adapter", "card": card, "dtype": "bfloat16",
           "images": ADAPTER_IMAGES, "grid_gb": y.numel() * 4 / 1e9,
           "data_s": data_s, "steps": steps,
           "step_ms_mean": ev[0].elapsed_time(ev[1]) / steps,
           "epoch_s": epoch_s, "epoch_loss": losses[0],
           "mse_init_1024": mse_init, "mse_trained_1024": mse_trained,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    del x, y, proj
    torch.cuda.empty_cache()
    if not (np.isfinite([losses[0], mse_trained]).all()
            and mse_trained < mse_init and losses[0] < mse_init):
        raise RuntimeError(f"adapter training: {row}")
    return row


# ——— phase 12: the reconstruction metric table at full backbone width ———

#: the table's rows, in JAX ``cmd_metrics``' order
METRIC_ROWS = ["pixcorr", "ssim"] + [
    f"{p}_{k}" for k in ("alexnet2", "alexnet5", "inception", "effnet",
                         "swav", "clip") for p in ("2way", "dist")]
#: the reference's 200 test concepts at the CLI's default ``--image-size``
METRIC_PAIRS, METRIC_SIZE = 200, 425


def write_metric_pickles(torch, tmp: str) -> dict:
    """Seeded AlexNet, InceptionV3, EfficientNet-B1 and ResNet-50 as the JAX
    ``--backbone-params`` pickle (``{alexnet, inception, effnet, swav}``
    flax trees) and the ViT-L/14 vision tower, filled on the card, as the
    ``--clip-params`` pickle; their sizes (BN statistics included)."""
    import pickle

    from eeg_image_decode_tpu_torch.eval import backbones as bb
    from eeg_image_decode_tpu_torch.models.clip_vit import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from eeg_image_decode_tpu_torch.utils.convert import (
        backbone_tree_from_state_dict,
    )
    from eeg_image_decode_tpu_torch.utils.convert_clip import (
        clip_tree_from_state_dict,
    )

    t0 = time.perf_counter()
    trees, params = {}, {}
    for i, (kind, make) in enumerate(bb.BACKBONES.items()):
        sd = bb.init_random(make(), SEED + 120 + i).state_dict()
        trees[kind] = backbone_tree_from_state_dict(kind, sd)
        params[kind] = sum(v.numel() for k, v in sd.items()
                           if not k.endswith("num_batches_tracked"))
    out = {"backbone_params": os.path.join(tmp, "metric_backbones.pkl"),
           "clip_params": os.path.join(tmp, "metric_clip_l14.pkl")}
    with open(out["backbone_params"], "wb") as f:
        pickle.dump(trees, f)
    cfg = CLIPVisionConfig.vit_l_14()
    with torch.device("cuda"):
        tower = CLIPVisionTower(cfg, seed=SEED + 125)
    params["clip"] = sum(p.numel() for p in tower.parameters())
    with open(out["clip_params"], "wb") as f:
        pickle.dump(clip_tree_from_state_dict(tower.state_dict(), "vision",
                                              cfg.heads), f)
    del tower
    out.update(params=params, write_s=time.perf_counter() - t0,
               pickle_mb={k: os.path.getsize(out[k]) / 1e6
                          for k in ("backbone_params", "clip_params")})
    return out


def _metrics_cli(argv: list[str]) -> dict:
    """``cli metrics`` in this process: the JSON row it prints first."""
    from eeg_image_decode_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["metrics", *argv])
    return json.loads(buf.getvalue().splitlines()[0])


def check_metric_table(table: dict, what: str) -> None:
    """14 rows in JAX's order, finite, correlations in [−1, 1], the 2-way
    rows in [0, 1]."""
    vals = np.array([table.get(k, np.nan) for k in METRIC_ROWS])
    bad = (list(table) != METRIC_ROWS or not np.isfinite(vals).all()
           or any(not -1 <= table[k] <= 1 for k in ("pixcorr", "ssim"))
           or any(not 0 <= v <= 1 for k, v in table.items()
                  if k.startswith("2way")))
    if bad:
        raise RuntimeError(f"metric table ({what}): {table}")


def metrics_cli_path(torch, card: str, tmp: str, pk: dict) -> dict:
    """``cli metrics`` on phase 6's ``cli generate`` tree (two seeds)
    against its 20 written JPEGs; the JPEGs (as a generate tree) against
    a flat copy of themselves; all through the
    pickles of :func:`write_metric_pickles`. The host's decode and resize
    beside the device's table; the six extractors on the card against the
    CPU."""
    import shutil

    from PIL import Image

    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.eval.recon_metrics import (
        pixcorr,
        reconstruction_metrics,
        ssim,
    )

    gen_dir = os.path.join(tmp, "generated_noise")
    # the ground truth flat, in concept order (a THINGS-layout tree would
    # read as a generate tree), and written as a generate tree
    # (class_XXXX/0.png)
    gt_dir, gt_tree = (os.path.join(tmp, d) for d in (
        "gt_flat", "gt_as_generate_tree"))
    os.makedirs(gt_dir)
    images = os.path.join(tmp, "gen_images")
    for i, concept in enumerate(sorted(os.listdir(images))):
        (name,) = os.listdir(os.path.join(images, concept))
        shutil.copy(os.path.join(images, concept, name),
                    os.path.join(gt_dir, f"{concept}.jpg"))
        os.makedirs(os.path.join(gt_tree, f"class_{i:04d}"))
        with Image.open(os.path.join(images, concept, name)) as im:
            im.save(os.path.join(gt_tree, f"class_{i:04d}", "0.png"))
    weights = ["--backbone-params", pk["backbone_params"], "--clip-params",
               pk["clip_params"]]
    tables, cli_s = {}, {}
    for run, (tree, gen_seed, gt) in {
            "seed0": (gen_dir, 0, gt_dir), "seed1": (gen_dir, 1, gt_dir),
            "self_distinct": (gt_tree, 0, gt_dir)}.items():
        out = os.path.join(tmp, f"metrics_{run}.csv")
        t0 = time.perf_counter()
        table = _metrics_cli(["--generated", tree, "--gen-seed",
                              str(gen_seed), "--ground-truth", gt, *weights,
                              "--out", out])
        cli_s[run] = time.perf_counter() - t0
        check_metric_table(table, run)
        with open(out) as f:
            lines = f.read().splitlines()
        csv_rows = dict(ln.split(",") for ln in lines[1:])
        if (lines[0] != "metric,value" or list(csv_rows) != list(table)
                or any(float(v) != table[k] for k, v in csv_rows.items())):
            raise RuntimeError(f"cli metrics {run}: the CSV {lines} is not "
                               f"the printed row {table}")
        tables[run] = table

    # a tree against itself: aligned pairs score 1 and distance 0, and on
    # distinct images every 2-way row is 1.0
    own = tables["self_distinct"]
    identity_ok = (own["pixcorr"] >= 0.9999 and own["ssim"] >= 0.9999
                   and all(v <= 1e-5 for k, v in own.items()
                           if k.startswith("dist"))
                   and all(v == 1.0 for k, v in own.items()
                           if k.startswith("2way")))

    # the host's part (PIL decode + bilinear resize to 425) and the
    # device's (the table on those pairs) apart
    t0 = time.perf_counter()
    gen = cli._load_image_batch(gen_dir, seed=0, size=METRIC_SIZE)
    gt = cli._load_image_batch(gt_dir, seed=0, size=METRIC_SIZE)
    load_ms = (time.perf_counter() - t0) * 1e3 / (len(gen) + len(gt))
    extractors = cli.build_metric_extractors(pk["backbone_params"],
                                             pk["clip_params"], "cuda")
    gen_c, gt_c = (torch.from_numpy(a).cuda() for a in (gen, gt))
    table_ms = cuda_ms(torch, lambda: reconstruction_metrics(
        gen_c, gt_c, extractors), reps=3)
    again = reconstruction_metrics(gen_c, gt_c, extractors)
    cli_gap = max(abs(again[k] - tables["seed0"][k]) for k in again)

    # the card against the CPU: the same modules, 4 pairs
    cpu = cli.build_metric_extractors(pk["backbone_params"],
                                      pk["clip_params"], "cpu")
    rel = {}
    for name, fn in extractors.items():
        errs = []
        for batch in (gen[:4], gt[:4]):
            want = cpu[name](torch.from_numpy(batch))
            got = fn(torch.from_numpy(batch).cuda()).cpu()
            errs.append(float((got - want).abs().max())
                        / float(want.abs().max()))
        rel[name] = max(errs)
    g4, t4 = torch.from_numpy(gen[:4]), torch.from_numpy(gt[:4])
    pix_ssim = {f"{name}_abs_err": abs(float(fn(g4.cuda(), t4.cuda()))
                                       - float(fn(g4, t4)))
                for name, fn in (("pixcorr", pixcorr), ("ssim", ssim))}
    del cpu
    gc.collect()
    row = {"phase": "metrics_cli", "card": card, "pairs": len(gen),
           "image_size": METRIC_SIZE, "tables": tables, "cli_s": cli_s,
           "identity_ok": identity_ok,
           "host_decode_resize_ms_per_image": load_ms,
           "device_table_ms": table_ms,
           "table_minus_cli_max_abs": cli_gap,
           "card_vs_cpu_rel_err": rel, **pix_ssim}
    emit(row)
    if (not identity_ok or cli_gap > 1e-5
            or any(v > 1e-4 for v in rel.values())
            or any(v > 1e-5 for v in pix_ssim.values())):
        raise RuntimeError(f"cli metrics: {row}")
    return row


def metrics_path(torch, card: str, pk: dict) -> dict:
    """The full-size table: ``METRIC_PAIRS`` pairs at ``METRIC_SIZE`` drawn
    on the card, all six extractors, with each extractor's time, operations
    and largest kernels."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.eval.recon_metrics import (
        pixcorr,
        reconstruction_metrics,
        ssim,
    )

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    extractors = cli.build_metric_extractors(pk["backbone_params"],
                                             pk["clip_params"], "cuda")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    shape = (METRIC_PAIRS, METRIC_SIZE, METRIC_SIZE, 3)
    gen = torch.rand(shape, generator=g, device="cuda")
    gt = (gen + 0.05 * torch.randn(shape, generator=g, device="cuda")
          ).clamp_(0, 1)
    t0 = time.perf_counter()
    table = reconstruction_metrics(gen, gt, extractors)  # cold
    first_s = time.perf_counter() - t0
    check_metric_table(table, "full size")
    total_ms = cuda_ms(torch, lambda: reconstruction_metrics(
        gen, gt, extractors), reps=3)
    per = {}
    for name, fn in extractors.items():
        def both(fn=fn):
            return fn(gen), fn(gt)
        ms = cuda_ms(torch, both, reps=3)
        flops = _flops(torch, both)
        per[name] = {"ms": ms, "tflop": flops / 1e12,
                     "tflops_per_s": flops / ms / 1e9,
                     "fp32_peak_share": flops / ms / 1e-3 / PEAK_FLOPS[
                         "float32"],
                     "top_kernels": top_kernels(torch, both, n=5)}
    row = {"phase": "metrics", "card": card, "dtype": "float32",
           "pairs": METRIC_PAIRS, "image_size": METRIC_SIZE,
           "table": table, "first_call_s": first_s, "total_ms": total_ms,
           "extractors": per,
           "pixcorr_ms": cuda_ms(torch, lambda: pixcorr(gen, gt), reps=5),
           "ssim_ms": cuda_ms(torch, lambda: ssim(gen, gt), reps=5),
           "weights_gb": weights_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": pk["params"]}
    emit(row)
    if table["2way_alexnet2"] < 0.5 or table["pixcorr"] < 0.9:
        raise RuntimeError(f"full-size metric table: {row}")
    return row


# ——— phase 13: the encoder zoo ———

ZOO = tuple(ZOO_PARAMS)
#: training steps of each zoo encoder but NICE, which trains one epoch
ZOO_STEPS = 8
#: the card's fp32 eval features against the CPU's on the same seeded
#: weights (TF32 off): max |Δ| over max |CPU feature|
ZOO_CPU_TOL = 1e-4
#: bf16 against fp32 eval features on the card: per-row cosine at least
ZOO_COSINE = 0.99


def zoo_forward_check(torch, name: str, rows) -> dict:
    """The encoder's eval forward on ``rows`` (a CPU tensor) with seeded
    weights at its defaults: the card in fp32 without TF32 against the
    CPU, and the card in bf16 against the card in fp32."""
    from eeg_image_decode_tpu_torch.models.registry import build_encoder

    with torch.no_grad():
        cpu, _ = build_encoder(name, device="cpu", seed=SEED)(rows)
        with tf32_off(torch):
            card, _ = build_encoder(name, device="cuda", seed=SEED)(
                rows.cuda())
        half, _ = build_encoder(name, dtype=torch.bfloat16, device="cuda",
                                seed=SEED)(rows.cuda())
    card, half = card.float().cpu(), half.float().cpu()
    err = float((card - cpu).abs().max() / cpu.abs().max())
    cos = torch.nn.functional.cosine_similarity(half, card, dim=1)
    if not (err <= ZOO_CPU_TOL and bool(torch.isfinite(half).all())
            and float(cos.min()) >= ZOO_COSINE):
        raise RuntimeError(f"{name}: eval forward, card fp32 against CPU "
                           f"{err} (≤ {ZOO_CPU_TOL}), bf16 cosine "
                           f"{cos.tolist()} (≥ {ZOO_COSINE})")
    return {"fp32_card_vs_cpu": err, "bf16_cosine_min": float(cos.min())}


def zoo_train_path(torch, card: str, name: str, train, test,
                   main_launches: dict) -> dict:
    """``build_encoder(name)`` at its defaults in bf16 on the card and
    ``ContrastiveTrainer`` at B 1024 on phase 4's resident split: NICE one
    epoch and ``evaluate()`` (its first step's gradients through the
    tsconv kernels held against the plain versions before it), each other
    encoder ``ZOO_STEPS`` steps of epoch 0's permutation."""
    from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
        epoch_permutation,
    )

    model = build_encoder(name, dtype=torch.bfloat16, device="cuda",
                          seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != ZOO_PARAMS[name]:
        raise RuntimeError(f"{name}: {n_params} parameters, the flax tree "
                           f"has {ZOO_PARAMS[name]}")
    tcfg = ContrastiveTrainConfig()
    trainer = ContrastiveTrainer(model, tcfg, train, test, device="cuda")
    grad = grad_check(torch, trainer, seeded=True) if name == "nice" else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    if name == "nice":
        metrics = trainer.train_epoch(0)
        losses = trainer.last_steps["step_loss"]
        step_ms = trainer.last_steps["step_ms"]
    else:
        perm = torch.as_tensor(epoch_permutation(
            train.n, TRAIN_BATCH, tcfg.seed, 0)[:ZOO_STEPS], device="cuda")
        out = trainer.epoch_fn(trainer.state, trainer.data, perm,
                               torch.Generator(device="cuda").manual_seed(
                                   tcfg.seed))
        losses, step_ms = out["step_loss"].tolist(), out["step_ms"]
        metrics = {"loss": float(np.mean(losses))}
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms[3:]))
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: non-finite training loss {losses}")
    row = {"phase": "zoo", "encoder": name, "card": card,
           "dtype": "bfloat16", "batch": TRAIN_BATCH, "params": n_params,
           "params_flax": ZOO_PARAMS[name], "steps": len(losses),
           "loss_mean": metrics["loss"], "loss_first": losses[0],
           "loss_last": losses[-1], "step_ms_p50": p50,
           "samples_per_s": TRAIN_BATCH / (p50 / 1e3), "train_s": train_s,
           "peak_mem_gb": peak, "launches_train": launches}
    if name == "nice":
        first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
        n_steps = len(losses)
        _build.reset_launches()
        row["eval"] = trainer.evaluate(0)
        eval_launches = dict(_build.LAUNCHES)
        if not (last8 < first8 and launches["tsconv_fwd"] == n_steps
                and launches["tsconv_bwd"] == n_steps
                and eval_launches["tsconv_fwd"] > 0
                and all(np.isfinite(v) for v in row["eval"].values())):
            raise RuntimeError(f"nice: loss first 8 {first8}, last 8 {last8}"
                               f"; launches {launches}, in the evaluation "
                               f"{eval_launches}; {row['eval']}")
        row.update(loss_first8=first8, loss_last8=last8,
                   launches_eval=eval_launches,
                   grad_check_worst_rel_l2=grad["worst_rel_l2"],
                   grad_check_worst_param=grad["worst_param"])
        add_launches(main_launches, launches)
        add_launches(main_launches, eval_launches)
    elif any(launches.values()):
        raise RuntimeError(f"{name} reaches no kernel, yet launched "
                           f"{launches}")
    del trainer, model
    row.update(zoo_forward_check(torch, name, test.eeg[:4].cpu()))
    emit(row)
    return row


def zoo_cli_path(torch, root: str, feats: str, tmp: str,
                 main_launches: dict) -> dict:
    """NICE through the CLI on phase 6's tree: ``train-retrieval --encoder
    nice`` for two epochs and ``--resume-dir`` for a third, ``evaluate``
    (equal to the trainer's last row), ``serve --run-dir --encoder nice``
    answering one 8-row ``/v1/retrieve`` (equal to ``top_k`` called
    directly), then ``cli smoke``."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.server import EEGDecodeServer

    ks, seed = "2,4,10,20", 7
    common = ["--data-path", root, "--features", feats, "--eval-ks", ks,
              "--subjects", "sub-01", "--encoder", "nice"]
    train_args = [*common, "--batch-size", "256", "--seed", str(seed)]
    _build.reset_launches()
    t0 = time.perf_counter()
    row2, run_dir = run_cli(["train-retrieval", *train_args, "--epochs",
                             "2", "--output-dir",
                             os.path.join(tmp, "zoo_runs")])
    row3, _ = run_cli(["train-retrieval", *train_args, "--epochs", "3",
                       "--resume-dir", run_dir])
    scored, _ = run_cli(["evaluate", *common, "--run-dir", run_dir,
                         "--seed", str(seed + 104729 * 2)])
    train_s = time.perf_counter() - t0
    tops = [k for k in row3 if k.startswith("top")]
    differ = {k: (scored.get(k), row3[k]) for k in tops
              if scored.get(k) != row3[k]}

    eeg = np.random.default_rng(SEED + 13).normal(
        size=(8, 63, 250)).astype(np.float32)
    sids = np.zeros(8, np.int32)
    served = {}

    def serve_once(server, host="127.0.0.1", port=8080):
        port = server.start(host=host, port=0)
        try:
            served["http"] = _post(
                f"http://127.0.0.1:{port}/v1/retrieve",
                _npz(eeg=eeg, subject_ids=sids, k=np.int64(5)),
                "application/octet-stream")
            served["direct"] = server.retrieval.top_k(eeg, sids, k=5)
        finally:
            server.stop()

    t0 = time.perf_counter()
    with mock.patch.object(EEGDecodeServer, "serve_forever", serve_once), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(["serve", "--run-dir", run_dir, "--encoder", "nice",
                  "--features", feats])
    serve_s = time.perf_counter() - t0
    scores, idx = served["direct"]
    same = (np.array_equal(np.asarray(served["http"]["indices"]), idx)
            and np.array_equal(np.asarray(served["http"]["scores"],
                                          np.float32), scores))
    t0 = time.perf_counter()
    smoke, _ = run_cli(["smoke"])
    smoke_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    row = {"phase": "zoo_cli", "encoder": "nice",
           "epochs": [row2["epoch"], row3["epoch"]],
           "loss": [row2["loss"], row3["loss"]], "checkpoints": ckpts,
           "evaluate": scored, "evaluate_equals_trainer": not differ,
           "serve_equals_top_k": same, "serve_indices": idx.tolist(),
           "smoke": smoke, "launches": launches, "train_evaluate_s": train_s,
           "serve_s": serve_s, "smoke_s": smoke_s}
    emit(row)
    smoke_ok = (sorted(smoke) == ["top1_k16", "top1_k2"]
                and all(np.isfinite(v) and 0.0 <= v <= 1.0
                        for v in smoke.values()))
    if (differ or not same or not smoke_ok or row3["epoch"] != 2
            or ckpts != ["2", "3"] or scored["step"] != 3
            or not (launches["tsconv_fwd"] and launches["tsconv_bwd"])):
        raise RuntimeError(f"zoo cli path: {row}")
    return row


# ——— phase 14: raw preprocessing, host-streamed training, THINGS-MEG ———

#: the card's whitened epochs against the numpy host path's (both fp32
#: outputs of fp64 covariances; the whitening products are fp32)
PREPROCESS_TOL = 1e-5
#: one THINGS-EEG2 session: 8,270 training conditions × 2 reps (16,540
#: events) and 200 test conditions × 20 reps (4,000 events)
#: (conditions, reps, images per class, first class, seed offset)
SESSION = {"training": (8270, 2, 10, 0, 1), "test": (200, 20, 1, 1654, 2)}


def preprocess_cli_path(torch, tmp: str, feats: str,
                        main_launches: dict) -> dict:
    """(a) ``cli preprocess`` on a written 2-session raw tree whose
    conditions are phase 6's tree's (30 classes × 10 images, 20 test
    concepts), then ``train-retrieval --streaming`` for two epochs on its
    output with phase 6's features, then ``evaluate``."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_raw_tree,
    )
    from eeg_image_decode_tpu_torch.ops import _build

    proj = os.path.join(tmp, "raw_project")
    t0 = time.perf_counter()
    write_synthetic_raw_tree(proj, sub=1, n_ses=2, n_train_conditions=300,
                             n_test_conditions=20, seed=SEED)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["preprocess", "--sub", "1", "--project-dir", proj,
                  "--n-ses", "2"])
    torch.cuda.synchronize()
    preprocess_s = time.perf_counter() - t0
    data = os.path.join(proj, "Preprocessed_data_250Hz")
    shapes = {}
    for part in ("training", "test"):
        with open(os.path.join(data, "sub-01",
                               f"preprocessed_eeg_{part}.npy"), "rb") as f:
            d = pickle.load(f)
        x = d["preprocessed_eeg_data"]
        if not np.isfinite(x).all():
            raise RuntimeError(f"preprocess: non-finite {part} epochs")
        shapes[part] = list(x.shape)
    if shapes != {"training": [300, 4, 63, 251], "test": [20, 40, 63, 251]}:
        raise RuntimeError(f"preprocess wrote {shapes}")

    ks, seed = "2,4,10,20", 7
    common = ["--data-path", data, "--features", feats, "--eval-ks", ks,
              "--subjects", "sub-01"]
    _build.reset_launches()
    t0 = time.perf_counter()
    row, run_dir = run_cli(["train-retrieval", *common, "--streaming",
                            "--batch-size", "256", "--seed", str(seed),
                            "--epochs", "2", "--output-dir",
                            os.path.join(tmp, "stream_runs")])
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    scored, _ = run_cli(["evaluate", *common, "--run-dir", run_dir,
                         "--seed", str(seed + 104729 * 1)])
    eval_launches = dict(_build.LAUNCHES)
    add_launches(main_launches, train_launches)
    add_launches(main_launches, eval_launches)
    tops = [k for k in row if k.startswith("top")]
    differ = {k: (scored.get(k), row[k]) for k in tops
              if scored.get(k) != row[k]}
    steps = 2 * (1200 // 256) + 2 * 1  # two epochs; one eval forward each
    missing = [k for k in ("attention_fwd_seed", "attention_bwd",
                           "tsconv_bwd") if train_launches[k] != 8] + [
        k for k in ("attention_fwd", "tsconv_fwd")
        if not eval_launches[k]]
    out = {"phase": "preprocess_cli", "shapes": shapes,
           "write_raw_s": write_s, "preprocess_s": preprocess_s,
           "epochs": row["epoch"], "loss": row["loss"], "evaluate": scored,
           "evaluate_equals_trainer": not differ,
           "launches_train": train_launches, "launches_eval": eval_launches,
           "train_s": train_s}
    emit(out)
    if (differ or missing or row["epoch"] != 1
            or train_launches["tsconv_fwd"] != steps
            or not np.isfinite(row["loss"])):
        raise RuntimeError(f"preprocess cli path: evaluate differs {differ}, "
                           f"launch counts wrong {missing}, row {out}")
    return out


def meg_cli_path(torch, tmp: str) -> dict:
    """(c) ``cli preprocess-meg`` on a written npz of THINGS-MEG-shaped
    epochs (271 sensors, 281 samples over [−0.1, 1.3] s): 24 concepts × 12
    images seen once, 2 zero-shot images seen 12 times, catch trials; the
    image → concept CSV; the pickles back through ``build_retrieval_data``
    at 12 images × 1 repetition."""
    from eeg_image_decode_tpu_torch import cli
    from eeg_image_decode_tpu_torch.data.things_eeg import (
        build_retrieval_data,
    )

    n_ch, n_t, n_cls, ipc = 271, 281, 24, 12
    rng = np.random.default_rng(SEED + 14)
    concepts = np.repeat(np.arange(1, n_cls + 3), ipc)  # 26 concepts
    # images of concepts 25-26 are the zero-shot ones: two of them repeat
    zs = [n_cls * ipc + 1, (n_cls + 1) * ipc + 1]
    events = np.concatenate([np.arange(1, n_cls * ipc + 1),
                             np.repeat(zs, 12), [999999] * 10])
    events = events[rng.permutation(len(events))]
    times = np.linspace(-0.1, 1.3, n_t)
    epochs = rng.standard_normal((len(events), n_ch, n_t), dtype=np.float32)
    npz = os.path.join(tmp, "meg_epochs.npz")
    np.savez(npz, epochs=epochs, event_ids=events, times=times,
             ch_names=np.asarray([f"MEG{i:04d}" for i in range(n_ch)]))
    csv_path = os.path.join(tmp, "image_concept_index.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(str(c) for c in concepts) + "\n")
    out_dir = os.path.join(tmp, "meg", "sub-01")
    t0 = time.perf_counter()
    summary, _ = run_cli(["preprocess-meg", "--epochs", npz, "--out",
                          out_dir, "--image-concept-csv", csv_path])
    meg_s = time.perf_counter() - t0
    n_keep = int(((times >= 0) & (times <= 1.0)).sum())
    train = build_retrieval_data(
        os.path.join(tmp, "meg"), ["sub-01"], train=True,
        img_features=np.zeros((n_cls * ipc, 8), np.float32),
        text_features=np.zeros((n_cls, 8), np.float32),
        images_per_class=ipc, train_reps=1)
    test = build_retrieval_data(
        os.path.join(tmp, "meg"), ["sub-01"], train=False,
        img_features=np.zeros((2, 8), np.float32),
        text_features=np.zeros((2, 8), np.float32))
    row = {"phase": "preprocess_meg", "summary": summary, "meg_s": meg_s,
           "train_loaded": list(train.eeg.shape),
           "test_loaded": list(test.eeg.shape)}
    emit(row)
    if (summary["train_shape"] != [n_cls, ipc, 1, n_ch, n_keep]
            or summary["test_shape"] != [2, 1, 12, n_ch, n_keep]
            or list(train.eeg.shape) != [n_cls * ipc, n_ch, n_keep]
            or list(test.eeg.shape) != [2, n_ch, n_keep]):
        raise RuntimeError(f"preprocess-meg: {row}")
    return row


def _busy_idle(torch, prof, wall_ms: float, steps: int) -> dict:
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, -1.0
    for a, b in spans:  # the union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms}


def host_cores() -> dict:
    """The host's CPUs as the process sees them."""
    return {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0))}


def streaming_path(torch, card: str, train_host, test,
                   main_launches: dict) -> dict:
    """(b) Phase 4's split on the host: one epoch resident, then streamed
    from fp32 and from bf16, each through the shared native gather pool
    and through the plain ``index_select`` gather, each from the same
    seeded init; then a traced second epoch each; one batch's gather (both
    routes, the pool at its default size, cores − 2, and at JAX's, a
    thread a core) and copy alone."""
    from torch.profiler import ProfilerActivity, profile

    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.data.native_loader import (
        GatherPool,
        shared_pool,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    cores = host_cores()
    modes = {}
    base_losses = None
    bench_src = {}
    for mode, streaming, host_dtype, gather in (
            ("resident", False, None, None),
            ("streamed_fp32", True, None, {}),
            ("streamed_fp32_plain", True, None, {"gather": "index_select"}),
            ("streamed_bf16", True, "bfloat16", {}),
            ("streamed_bf16_plain", True, "bfloat16",
             {"gather": "index_select"})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = ContrastiveTrainConfig(batch_size=TRAIN_BATCH,
                                     host_dtype=host_dtype)
        model = build_encoder("atms", config=ATMSConfig(),
                              dtype=torch.bfloat16, device="cuda", seed=SEED)
        trainer = ContrastiveTrainer(model, cfg, train_host, test,
                                     device="cuda", streaming=streaming)
        if gather:
            trainer.loader = trainer.loader.rerouted(**gather)
        _build.reset_launches()
        metrics = trainer.train_epoch(0)
        launches = dict(_build.LAUNCHES)
        losses = trainer.last_steps["step_loss"]
        step_ms = trainer.last_steps["step_ms"]
        n_steps = len(losses)
        peak = torch.cuda.max_memory_allocated() / 1e9
        wrong = {k: launches[k] for k in ("attention_fwd_seed",
                                          "attention_bwd", "tsconv_fwd",
                                          "tsconv_bwd")
                 if launches[k] != n_steps}
        if wrong or n_steps != train_host.n // TRAIN_BATCH:
            raise RuntimeError(f"{mode}: launches per step are not 1: "
                               f"{wrong} over {n_steps} steps")
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"{mode}: non-finite loss {losses}")
        in_epoch = {}
        if streaming:
            loader = trainer.loader
            if not gather:  # the trainer's own loader: the main path
                add_launches(main_launches, launches)
                bench_src[host_dtype or "float32"] = loader.arrays["eeg"]
            # the gather beside the training thread, and that thread's wait
            in_epoch = {
                "gather": "pool" if loader.is_native else "index_select",
                "pool_threads": (loader.pool.n_threads if loader.is_native
                                 else None),
                "gather_ms_in_epoch": float(np.mean(loader.gather_s)) * 1e3,
                "wait_ms_per_batch": float(np.mean(loader.wait_s)) * 1e3}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_epoch(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        row = {"step_ms_p50": float(np.median(step_ms[3:])),
               "step_ms_min": float(np.min(step_ms[3:])),
               "step_ms_max": float(np.max(step_ms[3:])),
               "samples_per_s": TRAIN_BATCH / (np.median(step_ms[3:]) / 1e3),
               "epoch_s": metrics["epoch_time_s"],
               "epoch_samples_per_s": metrics["samples_per_s"],
               "peak_mem_gb": peak, "steps": n_steps,
               "launches_per_step": {k: v / n_steps
                                     for k, v in launches.items() if v},
               "loss_first8": float(np.mean(losses[:8])),
               "loss_last8": float(np.mean(losses[-8:])), **in_epoch,
               **_busy_idle(torch, prof, wall_ms, n_steps)}
        if base_losses is None:
            base_losses = np.asarray(losses)
        else:
            d = np.abs(np.asarray(losses) - base_losses)
            row["step_loss_bit_equal_to_resident"] = bool(not d.any())
            row["step_loss_max_abs_diff"] = float(d.max())
            if d.any():
                raise RuntimeError(f"{mode}: step losses are not the "
                                   f"resident epoch's, bit for bit: max "
                                   f"|d| {d.max()}")
        modes[mode] = row
        trainer.close()
        del trainer, model, prof
    # one batch's gather into pinned memory, by each route, and its copy,
    # alone; a fresh permutation a repetition (the loader's access pattern)
    rng = np.random.default_rng(SEED)
    private = GatherPool(cores["affinity"])  # JAX's size, a thread a core
    routes = {"index_select": None,
              f"pool_{shared_pool().n_threads}_threads": shared_pool(),
              f"pool_{private.n_threads}_threads": private}
    per_batch = {}
    for host_dtype, src in bench_src.items():
        pinned = torch.empty((TRAIN_BATCH, *src.shape[1:]), dtype=src.dtype,
                             pin_memory=True)
        dev = torch.empty_like(pinned, device="cuda")
        nbytes = pinned.numel() * pinned.element_size()
        row = {"batch_mb": nbytes / 1e6}
        for route, pool in routes.items():
            gather = []
            for _ in range(12):
                idx = torch.from_numpy(rng.permutation(len(src))[:TRAIN_BATCH])
                t0 = time.perf_counter()
                if pool is None:
                    torch.index_select(src, 0, idx, out=pinned)
                else:
                    pool.wait(pool.submit(src, idx, pinned))
                gather.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(pinned, src.index_select(0, idx)):
                raise RuntimeError(f"{route}: the gathered batch is wrong")
            row[f"gather_ms_{route}"] = float(np.median(gather[2:]))
        copy_ms = cuda_ms(torch, lambda: dev.copy_(pinned, non_blocking=True))
        row.update(copy_ms=copy_ms, copy_gb_per_s=nbytes / copy_ms / 1e6)
        per_batch[host_dtype] = row
    private.close()
    bench_src.clear()
    out = {"phase": "streaming", "card": card, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "train_samples": train_host.n,
           "host_split_gb": train_host.eeg.numel() * 4 / 1e9,
           "host_cores": cores, "shared_pool_threads": shared_pool().n_threads,
           "modes": modes, "per_batch": per_batch,
           "peak_mem_saved_gb": (modes["resident"]["peak_mem_gb"]
                                 - modes["streamed_fp32"]["peak_mem_gb"]),
           "sidecar_read": "phase 18's fullscale_cli row, sidecar_reads"}
    emit(out)
    return out


def _np_epoch_session(raw, ch_names, sfreq, stim, max_rep, seed,
                      tmin=-0.2, tmax=1.0, target_sfreq=250.0,
                      drop_initial=50):
    """The JAX package's ``preprocess/epoching.py::epoch_session``, copied
    as numpy and scipy: the host path the card's is timed against."""
    from scipy.signal import resample_poly

    from eeg_image_decode_tpu_torch.preprocess.epoching import (
        CHANNEL_ORDER,
        TARGET_EVENT,
        find_events,
    )

    idx = [ch_names.index(ch) for ch in CHANNEL_ORDER if ch in ch_names]
    data = np.asarray(raw, np.float64)[idx]
    events = find_events(stim)
    events = events[events[:, 1] != TARGET_EVENT]
    n_pre, n_post = int(round(-tmin * sfreq)), int(round(tmax * sfreq))
    onsets, values = events[:, 0], events[:, 1]
    keep = (onsets - n_pre >= 0) & (onsets + n_post < data.shape[1])
    onsets, values = onsets[keep], values[keep]
    win = np.arange(-n_pre, n_post + 1)
    epochs = np.moveaxis(data[:, onsets[:, None] + win[None, :]], 1, 0)
    epochs = epochs - epochs[:, :, :n_pre].mean(axis=2, keepdims=True)
    up, down = int(target_sfreq), int(sfreq)
    g = np.gcd(up, down)
    epochs = resample_poly(epochs, up // g, down // g, axis=-1)
    conditions = np.unique(values)
    rng = np.random.RandomState(seed)
    out = np.zeros((len(conditions), max_rep, epochs.shape[1],
                    epochs.shape[-1]), np.float32)
    for i, cond in enumerate(conditions):
        cond_idx = np.nonzero(values == cond)[0]
        out[i] = epochs[cond_idx[rng.permutation(len(cond_idx))[:max_rep]]]
    return out[..., drop_initial:]


def _np_session_covariance(epoched, chunk=256):
    """The JAX package's batched Ledoit-Wolf and its mean, as numpy."""
    n_cond, n_rep, n_ch, t = epoched.shape
    x = epoched.reshape(n_cond * n_rep, n_ch, t).transpose(0, 2, 1)
    eye = np.eye(n_ch)
    total = np.zeros((n_ch, n_ch))
    for i in range(0, len(x), chunk):
        xi = np.array(x[i:i + chunk], np.float64)
        xi -= xi.mean(axis=1, keepdims=True)
        s = np.matmul(xi.transpose(0, 2, 1), xi) / t
        mu = np.trace(s, axis1=1, axis2=2) / n_ch
        delta = ((s - mu[:, None, None] * eye) ** 2).sum(axis=(1, 2)) / n_ch
        np.multiply(xi, xi, out=xi)
        beta = ((xi.sum(axis=2) ** 2).sum(axis=1) / t
                - (s ** 2).sum(axis=(1, 2))) / (t * n_ch)
        with np.errstate(divide="ignore", invalid="ignore"):
            shrink = np.clip(np.where(delta == 0, 0.0, beta / delta), 0, 1)
        total += ((1 - shrink)[:, None, None] * s
                  + (shrink * mu)[:, None, None] * eye).sum(axis=0)
    return total / len(x)


def _np_whitener(sigma):
    sigma = 0.5 * (sigma + sigma.T)
    w, v = np.linalg.eigh(sigma)
    w = np.maximum(w, 1e-12 * w.max())
    return (v * w ** -0.5) @ v.T


def preprocess_full_path(torch, card: str) -> dict:
    """(b) One THINGS-EEG2-sized session drawn on the host, preprocessed on
    the card (the port's functions) and on the host (the numpy copy of the
    JAX package's), stage by stage."""
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_raw_session,
    )
    from eeg_image_decode_tpu_torch.preprocess.epoching import (
        CHANNEL_ORDER,
        TARGET_EVENT,
        epoch_session,
        find_events,
        select_epochs,
    )
    from eeg_image_decode_tpu_torch.preprocess.mvnn import (
        matrix_inverse_sqrt,
        session_covariance,
    )

    import scipy.signal  # noqa: F401  (its import is not a stage's time)

    t0 = time.perf_counter()
    raws = {}
    for part, (n_cond, reps, ipc, off, k) in SESSION.items():
        raws[part] = make_synthetic_raw_session(
            n_cond, reps, images_per_class=ipc, class_offset=off,
            seed=SEED + k, topo_seed=SEED)
    draw_s = time.perf_counter() - t0

    def split(raw):
        names = raw["ch_names"]
        stim = names.index("stim")
        rows = [i for i in range(len(names)) if i != stim]
        return (raw["raw_eeg_data"][rows], [names[i] for i in rows],
                float(raw["sfreq"]), raw["raw_eeg_data"][stim])

    max_rep = {"training": 2, "test": 20}
    card_s, host_s = {}, {}
    # inside the card's epoch stage: the raw array's trip to the card and
    # the host's event bookkeeping, timed alone
    parts_s = {"copy_in": 0.0, "bookkeeping": 0.0}
    for part in raws:
        x, names, _, stim = split(raws[part])
        t0 = time.perf_counter()
        idx = [names.index(ch) for ch in CHANNEL_ORDER]
        d = torch.as_tensor(x)[idx].to("cuda", torch.float64)
        torch.cuda.synchronize()
        parts_s["copy_in"] += time.perf_counter() - t0
        del d
        t0 = time.perf_counter()
        ev = find_events(stim)
        select_epochs(ev[ev[:, 1] != TARGET_EVENT, 1], max_rep[part], SEED)
        parts_s["bookkeeping"] += time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ep = {part: epoch_session(*split(raws[part]),
                              max_rep=max_rep[part], seed=SEED,
                              device="cuda")[0] for part in raws}
    torch.cuda.synchronize()
    card_s["epochs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cov = session_covariance(ep["training"])
    torch.cuda.synchronize()
    card_s["lw_cov"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = matrix_inverse_sqrt(cov).float()
    white = {p: torch.matmul(w, e.reshape(-1, *e.shape[-2:])).reshape(
        e.shape) for p, e in ep.items()}
    torch.cuda.synchronize()
    card_s["whiten"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    white = {p: v.cpu().numpy() for p, v in white.items()}
    del ep, cov, w

    t0 = time.perf_counter()
    hep = {part: _np_epoch_session(*split(raws[part]), max_rep[part],
                                   SEED) for part in raws}
    host_s["epochs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hcov = _np_session_covariance(hep["training"])
    host_s["lw_cov"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hw = _np_whitener(hcov).astype(np.float32)
    hwhite = {p: np.matmul(hw, e.reshape(-1, *e.shape[-2:])).reshape(e.shape)
              for p, e in hep.items()}
    host_s["whiten"] = time.perf_counter() - t0
    err = max(float(np.abs(white[p] - hwhite[p]).max()
                    / np.abs(hwhite[p]).max()) for p in white)
    events = {p: int((raws[p]["raw_eeg_data"][-1] > 0).sum()) for p in raws}
    row = {"phase": "preprocess", "card": card,
           "shapes": {p: list(v.shape) for p, v in white.items()},
           "raw_samples": {p: raws[p]["raw_eeg_data"].shape[1]
                           for p in raws},
           "events_with_targets": events, "draw_raw_s": draw_s,
           "card_s": card_s, "card_total_s": sum(card_s.values()),
           "card_epochs_of_which_s": parts_s,
           "host_s": host_s, "host_total_s": sum(host_s.values()),
           "card_peak_mem_gb": peak,
           "epoch_tensor_fp64_gb": sum(
               v.shape[0] * v.shape[1] * 63 * 1201 * 8
               for v in white.values()) / 1e9,
           "max_rel_err_vs_host": err}
    emit(row)
    if err > PREPROCESS_TOL or not all(
            np.isfinite(v).all() for v in white.values()):
        raise RuntimeError(f"preprocess: the card's epochs differ from the "
                           f"host's by {err} of the largest")
    return row


# ——— phase 15: scale-out over torch.distributed ———

#: (c)'s steps at B 1024 over two ranks
SHARD_STEPS = 8
#: the time limit of one rank subprocess (s)
RANK_TIMEOUT = 300
#: (g): the tensor-parallel UNet's batch and latent size
TP_BATCH, TP_LATENT = 2, 128
#: (g): its forward against the unsharded one
TP_COSINE = 0.999
#: (f): the sweep's lanes (full ATM-S width, small splits)
SWEEP_SPLIT = dict(n_classes=200, images_per_class=10, train_reps=4,
                   n_test_classes=50)
SWEEP_KS = (2, 4, 10, 50)


def param_digest(torch, module) -> str:
    """SHA-256 of every parameter and buffer's bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for v in module.state_dict().values():
        h.update(v.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def sample0_kernels(torch) -> dict:
    """(a) Each seed-mode kernel at full ATM-S width in bf16: the launch over
    B 512 at sample0 = 512 gives the second half of the B 1024 launch's
    output and dx, bit for bit, and mask mode fed the plain draws at row0 =
    512 gives the same output."""
    from eeg_image_decode_tpu_torch.ops.attention import (
        draw_keep_masks,
        fused_attention_layer,
    )
    from eeg_image_decode_tpu_torch.ops.projection import (
        draw_keep_mask,
        fused_projection_head,
    )

    half = TRAIN_BATCH // 2
    bf = torch.bfloat16
    x, p, gout = attention_case(torch, bf, TRAIN_BATCH, SEED + 150)
    seed = torch.tensor([SEED % 2**31], dtype=torch.int32, device="cuda")

    def attn(xs, g, **kw):
        xs = xs.detach().clone().requires_grad_()
        out = fused_attention_layer(xs, p, HEADS, **kw)
        return out.detach(), torch.autograd.grad(out, xs, g)[0]

    whole, dx_whole = attn(x, gout, dropout_p=P_DROP, seed=seed)
    part, dx_part = attn(x[half:], gout[half:], dropout_p=P_DROP, seed=seed,
                         sample0=half)
    masks = draw_keep_masks(SEED % 2**31, half, HEADS, L_TOK, D_MODEL, D_FF,
                            P_DROP, row0=half, device="cuda")
    via_masks, _ = attn(x[half:], gout[half:],
                        masks={k: v.to(bf) for k, v in masks.items()})

    g = torch.Generator(device="cuda").manual_seed(SEED + 151)
    pp = {"wi": torch.randn(D_IN, D_OUT, generator=g, device="cuda")
          * D_IN ** -0.5, "bi": 0.1 * torch.randn(D_OUT, generator=g,
                                                   device="cuda"),
          "wr": torch.randn(D_OUT, D_OUT, generator=g, device="cuda")
          * D_OUT ** -0.5, "br": 0.1 * torch.randn(D_OUT, generator=g,
                                                    device="cuda"),
          "ln_s": 1 + 0.1 * torch.randn(D_OUT, generator=g, device="cuda"),
          "ln_b": 0.1 * torch.randn(D_OUT, generator=g, device="cuda")}
    pp = {k: v.to(bf) for k, v in pp.items()}
    xp = torch.randn(TRAIN_BATCH, D_IN, generator=g, device="cuda").to(bf)
    gp = torch.randn(TRAIN_BATCH, D_OUT, generator=g, device="cuda")

    def proj(xs, gs, *args, **kw):
        xs = xs.detach().clone().requires_grad_()
        out = fused_projection_head(xs, pp, *args, **kw)
        return out.detach(), torch.autograd.grad(out, xs, gs)[0]

    pseed = SEED % 2**31 + 1
    pw, pdx_w = proj(xp, gp, None, P_DROP_PROJ, pseed)
    pp_, pdx_p = proj(xp[half:], gp[half:], None, P_DROP_PROJ, pseed,
                      sample0=half)
    pmask = draw_keep_mask(pseed, half, D_OUT, P_DROP_PROJ, row0=half,
                           device="cuda")
    p_via, _ = proj(xp[half:], gp[half:], pmask.to(bf))
    torch.cuda.synchronize()
    checks = {
        "attention_fwd_seed_out": torch.equal(part, whole[half:]),
        "attention_bwd_dx": torch.equal(dx_part, dx_whole[half:]),
        "attention_masks_row0": torch.equal(part, via_masks),
        "projection_fwd_seed_out": torch.equal(pp_, pw[half:]),
        "projection_bwd_dx": torch.equal(pdx_p, pdx_w[half:]),
        "projection_mask_row0": torch.equal(pp_, p_via),
    }
    row = {"phase": "dp_sample0", "dtype": "bfloat16", "batch": TRAIN_BATCH,
           "sample0": half, "bit_equal": checks}
    emit(row)
    if not all(checks.values()):
        raise RuntimeError(f"sample0 launches differ: {checks}")
    return row


def _trainer(torch, train, test, *, mesh=None, config=None, tcfg=None,
             **kw):
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
    )

    model = build_encoder("atms", config=config or ATMSConfig(),
                          dtype=torch.bfloat16, device="cuda", seed=SEED)
    return ContrastiveTrainer(model, tcfg or ContrastiveTrainConfig(), train,
                              test, device="cuda", mesh=mesh, **kw)


def mesh_train_path(torch, card: str, train_host, test, mesh,
                    main_launches: dict) -> dict:
    """(b) One NCCL rank: an epoch of phase 4's split without and with the
    mesh from one init (bit-equal step losses), the mesh epoch's launches
    and collectives a step, then a traced second mesh epoch: busy and
    idle."""
    from torch.profiler import ProfilerActivity, profile

    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.parallel import collectives

    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = _trainer(torch, train_host, test, mesh=m)
        _build.reset_launches()
        collectives.reset_counts()
        tr.train_epoch(0)
        launches, counts = dict(_build.LAUNCHES), dict(collectives.COUNTS)
        n = len(tr.last_steps["step_loss"])
        runs[name] = {"loss": np.asarray(tr.last_steps["step_loss"]),
                      "step_ms": tr.last_steps["step_ms"],
                      "launches": launches, "collectives": counts,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if m is not None:
            add_launches(main_launches, launches)
            _build.reset_launches()
            evaluation = tr.evaluate(0)
            runs[name]["eval_launches"] = dict(_build.LAUNCHES)
            add_launches(main_launches, runs[name]["eval_launches"])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.train_epoch(1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            runs[name]["trace"] = _busy_idle(torch, prof, wall_ms, n)
            del prof
        del tr
    plain, dp = runs["plain"], runs["mesh"]
    n = len(dp["loss"])
    bit_equal = bool(np.array_equal(plain["loss"], dp["loss"]))
    row = {"phase": "dp_train_one_rank", "card": card, "backend": "nccl",
           "world": mesh.dp, "dtype": "bfloat16", "batch": TRAIN_BATCH,
           "train_samples": train_host.n, "steps": n,
           "step_loss_bit_equal": bit_equal,
           "step_loss_max_abs_diff": float(np.abs(plain["loss"]
                                                  - dp["loss"]).max()),
           "plain_step_ms_p50": float(np.median(plain["step_ms"][3:])),
           "mesh_step_ms_p50": float(np.median(dp["step_ms"][3:])),
           "mesh_step_ms_min": float(np.min(dp["step_ms"][3:])),
           "plain_peak_mem_gb": plain["peak_gb"],
           "mesh_peak_mem_gb": dp["peak_gb"],
           "collectives_per_step": {k: v / n for k, v in
                                    dp["collectives"].items()},
           "launches_per_step": {k: v / n for k, v in dp["launches"].items()
                                 if v},
           "eval_launches": {k: v for k, v in dp["eval_launches"].items()
                             if v},
           "eval": evaluation, **dp["trace"]}
    emit(row)
    wrong = {k: dp["launches"][k] for k in ("attention_fwd_seed",
                                            "attention_bwd", "tsconv_fwd",
                                            "tsconv_bwd")
             if dp["launches"][k] != n}
    if not bit_equal or wrong:
        raise RuntimeError(f"one-rank mesh epoch: bit-equal {bit_equal}, "
                           f"launches off {wrong}")
    return row


def mesh_cli_path(torch, tmp: str) -> dict:
    """(b) ``cli train-retrieval --mesh`` on a small written tree in this
    process (the one-rank NCCL group), against the same command without
    ``--mesh``: the same results, bit for bit."""
    from eeg_image_decode_tpu_torch.data.synthetic import (
        write_synthetic_things_tree,
    )

    root = os.path.join(tmp, "things_mesh")
    feats = write_synthetic_things_tree(root, ("sub-01",), n_classes=8,
                                        n_test_classes=4, train_reps=2,
                                        seed=SEED + 152)
    common = ["train-retrieval", "--data-path", root, "--features", feats,
              "--eval-ks", "2,4", "--batch-size", "32", "--train-reps", "2",
              "--epochs", "2", "--seed", "3"]
    t0 = time.perf_counter()
    plain, _ = run_cli([*common, "--output-dir", os.path.join(tmp, "p")])
    dp, run_dir = run_cli([*common, "--output-dir", os.path.join(tmp, "m"),
                           "--mesh"])
    keys = [k for k in plain if k not in ("epoch_time_s", "samples_per_s")]
    same = all(plain[k] == dp[k] for k in keys)
    row = {"phase": "dp_cli", "command": "train-retrieval --mesh",
           "world": 1, "rows_equal": same, "loss": dp["loss"],
           "results_csv": os.path.exists(os.path.join(run_dir,
                                                      "results.csv")),
           "s": time.perf_counter() - t0}
    emit(row)
    if not (same and row["results_csv"]):
        raise RuntimeError(f"cli --mesh: {plain} vs {dp}")
    return row


def mesh_fused_joint_path(torch, card: str, train_host, test, mesh,
                          main_launches: dict) -> dict:
    """(d) ``fused_projection=True, joint_train=True`` under the one-rank
    mesh: 8 steps and an evaluation, rows 6, 6′ and 7 launched under dp,
    against the same steps without the mesh."""
    from eeg_image_decode_tpu_torch.core.config import ATMSConfig
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        epoch_permutation,
    )

    ids = np.random.default_rng(SEED + 30).integers(0, 10, train_host.n)
    train = dataclasses.replace(train_host, subject_ids=torch.from_numpy(ids))
    acfg = ATMSConfig(fused_projection=True, joint_train=True)
    perm = epoch_permutation(train.n, TRAIN_BATCH, 0, 0)[:8]
    losses, launches = {}, {}
    for name, m in (("plain", None), ("mesh", mesh)):
        tr = _trainer(torch, train, test, mesh=m, config=acfg)
        _build.reset_launches()
        tr.train_epoch(0, perm=perm)
        tr.evaluate(0)
        launches[name] = dict(_build.LAUNCHES)
        losses[name] = np.asarray(tr.last_steps["step_loss"])
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    add_launches(main_launches, launches["mesh"])
    d = float(np.abs(losses["plain"] - losses["mesh"]).max())
    row = {"phase": "dp_fused_joint", "card": card, "world": mesh.dp,
           "steps": len(perm), "step_loss_bit_equal": d == 0.0,
           "step_loss_max_abs_diff": d,
           "launches": {k: v for k, v in launches["mesh"].items() if v}}
    emit(row)
    need = ("projection_fwd_seed", "projection_bwd", "projection_fwd")
    if d > RESUME_TOL or not all(launches["mesh"][k] for k in need):
        raise RuntimeError(f"fused joint under the mesh: {row}")
    return row


def mesh_prior_lowlevel_path(torch, card: str, mesh) -> dict:
    """(e) The prior (8,192 pairs, B 1024, one epoch) and the low-level
    trainer (300 trials, B 30, one epoch) at full width, each without and
    with the one-rank mesh from one init: bit-equal losses."""
    from eeg_image_decode_tpu_torch.core.config import (
        LowLevelConfig,
        PriorConfig,
    )
    from eeg_image_decode_tpu_torch.train.lowlevel import LowLevelTrainer
    from eeg_image_decode_tpu_torch.train.prior import PriorPipe

    rng = np.random.default_rng(SEED + 153)
    c = rng.normal(size=(8192, 1024)).astype(np.float32)
    h = rng.normal(size=(8192, 1024)).astype(np.float32)
    eeg = rng.normal(size=(300, 63, 250)).astype(np.float32)
    lat = rng.normal(size=(300, 4, 64, 64)).astype(np.float32)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        pipe = PriorPipe(PriorConfig(), device=None if m else "cuda", mesh=m)
        pipe.train(c, h, epochs=1, log_fn=None)
        low = LowLevelTrainer(LowLevelConfig(), device=None if m else "cuda",
                              mesh=m)
        low.train(eeg, lat, epochs=1, log_fn=None)
        out[name] = {
            "prior": pipe.last_steps["step_loss"].cpu().numpy(),
            "prior_ms": pipe.last_steps["step_ms"],
            "lowlevel": low.last_steps["step_loss"].cpu().numpy(),
            "lowlevel_ms": low.last_steps["step_ms"]}
        del pipe, low
        gc.collect()
        torch.cuda.empty_cache()
    eq = {k: bool(np.array_equal(out["plain"][k], out["mesh"][k]))
          for k in ("prior", "lowlevel")}
    row = {"phase": "dp_prior_lowlevel", "card": card, "world": mesh.dp,
           "bit_equal": eq,
           "prior_steps": len(out["mesh"]["prior"]),
           "lowlevel_steps": len(out["mesh"]["lowlevel"]),
           **{f"{k}_{n}_step_ms_p50": float(np.median(out[n][f"{k}_ms"][2:]))
              for k in ("prior", "lowlevel") for n in ("plain", "mesh")}}
    emit(row)
    if not all(eq.values()):
        raise RuntimeError(f"prior/low-level under the mesh: {row}")
    return row


def _tp_unet(torch, seed: int):
    from eeg_image_decode_tpu_torch.gen.sdxl import fill_random_
    from eeg_image_decode_tpu_torch.gen.unet import SDXLUNet, SDXLUNetConfig

    with torch.device("meta"):
        unet = SDXLUNet(SDXLUNetConfig.sdxl_turbo(), dtype=torch.bfloat16)
    unet.to_empty(device="cuda")
    fill_random_(unet, seed)
    return unet.eval()


def _tp_inputs(torch):
    g = torch.Generator(device="cuda").manual_seed(SEED + 154)
    lat = torch.randn(TP_BATCH, 4, TP_LATENT, TP_LATENT, generator=g,
                      device="cuda")
    ctx = torch.randn(TP_BATCH, 77, 2048, generator=g, device="cuda")
    emb = torch.randn(TP_BATCH, 1024, generator=g, device="cuda")
    t = torch.tensor([999, 499], device="cuda")
    return lat, t, ctx, emb


def _sweep_lane(torch, lane: int):
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )

    return make_synthetic_retrieval_data(**SWEEP_SPLIT,
                                         seed=SEED + 160 + lane,
                                         device="cuda")


def rank_worker(argv: list[str]) -> int:
    """One rank of phase 15 (c), (f), (g): ``chip_smoke.py --rank RANK
    WORLD RENDEZVOUS DIR``. Joins a gloo group on cuda:0 (the two ranks
    share the one card), writes ``DIR/<case>_r<RANK>.pt`` per case."""
    import torch
    import torch.distributed as dist

    from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
    from eeg_image_decode_tpu_torch.core.mesh import create_mesh
    from eeg_image_decode_tpu_torch.data.synthetic import (
        make_synthetic_retrieval_data,
    )
    from eeg_image_decode_tpu_torch.gen.sharding import (
        shard_params,
        sharded_unet_apply,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.parallel import collectives, multihost
    from eeg_image_decode_tpu_torch.train.sweep import SubjectParallelSweep
    from eeg_image_decode_tpu_torch.utils.device import resolve_device

    rank, world, rdv, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    resolve_device("cuda")
    multihost.initialize(device="cuda:0", backend="gloo",
                         init_method="file://" + rdv, rank=rank,
                         world_size=world)
    mesh = create_mesh(device="cuda:0")

    def save(case, obj):
        torch.save(obj, os.path.join(out_dir, f"{case}_r{rank}.pt"))

    # (c) --mesh --shard-data: two ranks, B 1024 global, SHARD_STEPS steps
    train, test = make_synthetic_retrieval_data(
        n_classes=1654, n_test_classes=200, seed=SEED, device="cuda")
    train = dataclasses.replace(train, **{
        f: getattr(train, f).cpu() for f in (
            "eeg", "labels", "subject_ids", "img_idx", "text_idx",
            "img_features", "text_features")})
    checksum = float(train.eeg[:64].double().sum())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = _trainer(torch, train, test, mesh=mesh, shard_samples=True)
    perm = tr.epoch_perm(0)[:SHARD_STEPS]
    collectives.reset_counts()
    t0 = time.perf_counter()
    tr.train_epoch(0, perm=perm)
    save("shard", {"loss": tr.last_steps["step_loss"],
                   "step_ms": tr.last_steps["step_ms"],
                   "s": time.perf_counter() - t0,
                   "collectives": dict(collectives.COUNTS),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "rows": int(tr.data.eeg.shape[0]),
                   "digest": param_digest(torch, tr.model),
                   "checksum": checksum})
    del tr, train, test
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the sweep: lane i on rank i
    lanes = [_sweep_lane(torch, i) for i in range(world)]
    cfg = ContrastiveTrainConfig(eval_ks=SWEEP_KS)
    sweep = SubjectParallelSweep(
        lambda seed: build_encoder("atms", dtype=torch.bfloat16,
                                   device="cuda:0", seed=seed),
        cfg, [a for a, _ in lanes], [b for _, b in lanes], mesh=mesh,
        seeds=[SEED + i for i in range(world)])
    t0 = time.perf_counter()
    history = sweep.fit(1, log_fn=None)
    save("sweep", {"history": history, "s": time.perf_counter() - t0,
                   "digests": {i: param_digest(torch,
                                               sweep.subject_trainer(i).model)
                               for i in sweep.lanes}})
    del sweep, lanes
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the tensor-parallel UNet: mp = world
    tp = create_mesh(data_parallel=1, model_parallel=world, device="cuda:0")
    unet = _tp_unet(torch, SEED + 155)
    n_full = sum(p.numel() for p in unet.parameters())
    shard_params(tp, unet)
    gc.collect()
    torch.cuda.empty_cache()
    fwd = sharded_unet_apply(unet, tp)
    inputs = _tp_inputs(torch)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fwd(*inputs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    save("unet", {"out": out.float().cpu() if rank == 0 else None,
                  "s": secs,
                  "params": sum(p.numel() for p in unet.parameters()),
                  "params_full": n_full})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def launch_rank_workers(world: int, directory: str) -> dict:
    """Run :func:`rank_worker` as ``world`` processes; each has its own
    time limit, and a rank that fails or hangs stops the others and fails
    the phase. Returns {case: [rank 0's output, …]}."""
    import torch

    rdv = os.path.join(directory, "rendezvous")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    logs = [os.path.join(directory, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 str(world), rdv, directory], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else None
                with open(logs[r if r is not None else 0]) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(
                    f"rank {r} exited {procs[r].returncode}:\n{tail}"
                    if failed else f"ranks outlived {RANK_TIMEOUT} s:\n"
                    f"{tail}")
            time.sleep(0.5)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            with open(logs[bad[0]]) as f:
                raise RuntimeError(f"rank {bad[0]} exited "
                                   f"{procs[bad[0]].returncode}:\n"
                                   f"{f.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {case: [torch.load(os.path.join(directory, f"{case}_r{r}.pt"),
                              weights_only=False) for r in range(world)]
            for case in ("shard", "sweep", "unet")}


def two_rank_paths(torch, card: str, train_host, test, mesh,
                   resident_peak_gb: float) -> dict:
    """(c), (f), (g): correctness runs of two gloo ranks sharing the one
    card, each against its one-rank or sequential run made here first."""
    from eeg_image_decode_tpu_torch.core.config import ContrastiveTrainConfig
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
        sharded_epoch_perm,
        sharded_perm_rows,
    )

    world = 2
    t_all = time.perf_counter()
    # (c)'s reference: the one-rank mesh over the same global rows
    perm = sharded_perm_rows(
        sharded_epoch_perm(train_host.n, TRAIN_BATCH, world, 0, 0),
        train_host.n, world)[:SHARD_STEPS]
    ref = _trainer(torch, train_host, test, mesh=mesh)
    ref.train_epoch(0, perm=perm)
    ref_loss = np.asarray(ref.last_steps["step_loss"])
    ref_checksum = float(torch.as_tensor(train_host.eeg[:64]).double().sum())
    del ref
    # (f)'s reference: each lane's sequential run
    seq = []
    for i in range(world):
        tr_i, te_i = _sweep_lane(torch, i)
        model = build_encoder("atms", dtype=torch.bfloat16, device="cuda",
                              seed=SEED + i)
        tr = ContrastiveTrainer(
            model, ContrastiveTrainConfig(eval_ks=SWEEP_KS, seed=SEED + i),
            tr_i, te_i, device="cuda")
        seq.append((tr.fit(1, log_fn=None), param_digest(torch, model)))
        del tr, model, tr_i, te_i
    # (g)'s reference: the unsharded forward
    unet = _tp_unet(torch, SEED + 155)
    unsharded_s = []
    with torch.no_grad():
        lat, t, ctx, emb = _tp_inputs(torch)
        for _ in range(2):  # the first call builds cuDNN's plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = unet(lat, t, ctx, None, None, emb).float()
            torch.cuda.synchronize()
            unsharded_s.append(time.perf_counter() - t0)
    want = want.cpu()
    del unet
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as d:
        t0 = time.perf_counter()
        got = launch_rank_workers(world, d)
        ranks_s = time.perf_counter() - t0

    shard = got["shard"]
    d0 = abs(float(shard[0]["loss"][0]) - float(ref_loss[0]))
    dmax = float(np.abs(np.asarray(shard[0]["loss"]) - ref_loss).max())
    split_gb = train_host.eeg.numel() * 4 / 1e9
    c = {"phase": "dp_shard_two_ranks", "card": card, "backend": "gloo",
         "world": world, "note": "two processes sharing one card: a "
         "correctness run, not a scaling number", "batch": TRAIN_BATCH,
         "steps": SHARD_STEPS, "rows_per_rank": shard[0]["rows"],
         "step0_abs_diff": d0, "max_abs_diff": dmax,
         "ranks_loss_equal": bool(np.array_equal(shard[0]["loss"],
                                                 shard[1]["loss"])),
         "params_bit_equal": shard[0]["digest"] == shard[1]["digest"],
         "split_regenerated_equal": all(r["checksum"] == ref_checksum
                                        for r in shard),
         "peak_mem_gb": [r["peak_gb"] for r in shard],
         "resident_peak_mem_gb": resident_peak_gb, "split_gb": split_gb,
         "step_ms_p50": [float(np.median(r["step_ms"][2:])) for r in shard],
         "collectives_per_step": {k: v / SHARD_STEPS for k, v in
                                  shard[0]["collectives"].items()}}
    emit(c)
    saved = [resident_peak_gb - p for p in c["peak_mem_gb"]]
    if not (c["split_regenerated_equal"] and d0 <= 1e-3
            and dmax <= RESUME_TOL and c["params_bit_equal"]
            and c["ranks_loss_equal"] and min(saved) >= split_gb / 2 - 0.05):
        raise RuntimeError(f"two-rank --shard-data run: {c}")

    sweep = got["sweep"]
    lanes = {}
    for i, (hist, digest) in enumerate(seq):
        row_got = sweep[0]["history"][i][0]
        keys = [k for k in hist[0] if k == "loss" or k == "train_acc"
                or k.startswith("top")]
        lanes[i] = {"rows_equal": all(row_got[k] == hist[0][k]
                                      for k in keys),
                    "params_bit_equal": sweep[i]["digests"][i] == digest,
                    "loss": row_got["loss"],
                    "epoch_time_s": row_got["epoch_time_s"]}
    f = {"phase": "dp_sweep_two_ranks", "card": card, "backend": "gloo",
         "lanes": lanes, "fit_s": [r["s"] for r in sweep],
         "note": "two processes sharing one card: a correctness run"}
    emit(f)
    if not all(v["rows_equal"] and v["params_bit_equal"]
               for v in lanes.values()):
        raise RuntimeError(f"sweep lanes differ from sequential runs: {f}")

    out = got["unet"][0]["out"]
    cos = float(torch.nn.functional.cosine_similarity(
        out.reshape(TP_BATCH, -1), want.reshape(TP_BATCH, -1)).min())
    g = {"phase": "dp_tp_unet", "card": card, "backend": "gloo", "mp": world,
         "dtype": "bfloat16", "batch": TP_BATCH,
         "latent": [TP_LATENT, TP_LATENT], "cosine_min": cos,
         "cosine_limit": TP_COSINE,
         "sharded_forward_s": got["unet"][0]["s"],
         "unsharded_forward_s": unsharded_s,
         "params_per_rank": got["unet"][0]["params"],
         "params_full": got["unet"][0]["params_full"],
         "note": "two processes sharing one card over gloo: the gathers go "
                 "through the host; a correctness run, not a speed"}
    emit(g)
    if not cos >= TP_COSINE:
        raise RuntimeError(f"tensor-parallel UNet: cosine {cos}")
    emit({"phase": "dp_two_ranks_total", "ranks_s": ranks_s,
          "s": time.perf_counter() - t_all})
    return {"shard": c, "sweep": f, "unet": g}


def scale_out_paths(torch, card: str, train_host, test,
                    main_launches: dict) -> dict:
    """Phase 15, (a)-(g)."""
    from eeg_image_decode_tpu_torch.core.mesh import create_mesh
    from eeg_image_decode_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    sample0_kernels(torch)
    multihost.initialize(device="cuda")            # one NCCL rank
    mesh = create_mesh(device="cuda")
    b = mesh_train_path(torch, card, train_host, test, mesh, main_launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh_cli_path(torch, tmp)
    mesh_fused_joint_path(torch, card, train_host, test, mesh,
                          main_launches)
    mesh_prior_lowlevel_path(torch, card, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    two_rank_paths(torch, card, train_host, test, mesh,
                   b["mesh_peak_mem_gb"])
    torch.distributed.destroy_process_group()
    emit({"phase": "phase15_total", "s": time.perf_counter() - t0})



# ——— phase 16: the acceptance runbook ———

#: phase 16 (b)'s tree, written by the runbook's own tree writer: THINGS-EEG's
#: layout and widths (63 channels × 250 samples, 10 images × 4 repetitions a
#: training concept, 200 test concepts), cut to 200 of its 1,654 training
#: concepts and 4 of its 80 test repetitions
RUNBOOK_TREE = {"n_cls": 200, "test_reps": 4, "seed": SEED + 160}


def load_script(name: str):
    """``scripts/<name>.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runbook():
    """``scripts/acceptance_torch.py`` of this checkout, as a module."""
    return load_script("acceptance_torch")


def _runbook(runbook, argv: list[str]) -> tuple[int, dict, dict]:
    """The runbook's ``main(argv)`` in this process: (exit code, the
    report, seconds per stage as the report records them)."""
    rc = runbook.main(argv)
    work = argv[argv.index("--work-dir") + 1]
    with open(os.path.join(work, "acceptance_report.json")) as f:
        report = json.load(f)
    return rc, report, {r["stage"]: r.get("seconds")
                        for r in report["stages"]}


def _report_stages(report: dict, what: str) -> dict:
    stages = {r["stage"]: r for r in report["stages"]}
    if set(stages) != {"retrieval", "prior", "generate", "metrics"}:
        raise RuntimeError(f"runbook ({what}): stages {sorted(stages)}")
    return stages


def runbook_path(pk: dict, main_launches: dict) -> dict:
    """Phase 16, (a) and (b), with phase 12's metric pickles ``pk``; the
    launches of both count into the main path. Returns (b)'s row."""
    from eeg_image_decode_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    runbook = load_runbook()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runbook_") as tmp:
        # (a) the dry run on the card
        _build.reset_launches()
        t0 = time.perf_counter()
        work = os.path.join(tmp, "dry")
        rc, report, stage_s = _runbook(runbook, ["--dry-run", "--device",
                                                 "cuda", "--work-dir", work])
        dry_s = time.perf_counter() - t0
        add_launches(main_launches, _build.LAUNCHES)
        stages = _report_stages(report, "dry run")
        table = stages["metrics"].get("table", {})
        dry = {"phase": "runbook_dry_run", "rc": rc, "ok": report["ok"],
               "status": {k: v["status"] for k, v in stages.items()},
               "images": stages["generate"]["images"],
               "expected": stages["generate"]["expected"], "table": table,
               "stage_s": stage_s, "s": dry_s,
               "launches": dict(_build.LAUNCHES)}
        emit(dry)
        if (rc != 0 or not report["ok"]
                or dry["images"] != dry["expected"] or not table
                or not all(np.isfinite(v) for v in table.values())):
            raise RuntimeError(f"runbook dry run on the card: {dry}")

        # (b) the real mode at full width
        t0 = time.perf_counter()
        data_path, features, gt_dir, n_test = runbook._write_dry_run_tree(
            os.path.join(tmp, "tree"), **RUNBOOK_TREE)
        write_s = time.perf_counter() - t0
        n_cls = RUNBOOK_TREE["n_cls"]
        n_train = n_cls * 10 * 4
        print("runbook tree:", json.dumps({
            "shapes": {"training": [n_cls * 10, 4, 63, 250],
                       "test": [n_test, RUNBOOK_TREE["test_reps"], 63, 250]},
            "tree": RUNBOOK_TREE,
            "cut": "THINGS-EEG: 1,654 training concepts (here 200) and 80 "
                   "test repetitions (here 4); widths as published"}),
            flush=True)
        work = os.path.join(tmp, "real")
        _build.reset_launches()
        t0 = time.perf_counter()
        rc, report, stage_s = _runbook(runbook, [
            "--data-path", data_path, "--features", features,
            "--ground-truth", gt_dir,
            "--backbone-params", pk["backbone_params"],
            "--clip-params", pk["clip_params"], "--epochs-retrieval", "2",
            "--epochs-prior", "2", "--seeds", "1", "--batch-size", "1024",
            "--device", "cuda", "--work-dir", work])
        real_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        add_launches(main_launches, launches)
        stages = _report_stages(report, "full width")
        with np.load(os.path.join(work, "eeg_features.npz")) as d:
            exported = {k: list(d[k].shape) for k in d.files}
            finite = all(np.isfinite(d[k]).all() for k in d.files)
        pngs = len([p for _, _, files in os.walk(os.path.join(
            work, "generated")) for p in files if p.endswith(".png")])
        table = stages["metrics"].get("table", {})
        steps = 2 * (n_train // 1024)
        out = {"phase": "runbook", "rc": rc, "ok": report["ok"],
               "stages": report["stages"], "exported": exported,
               "prior_pickle": os.path.exists(os.path.join(
                   work, "prior", "diffusion_prior.pkl")),
               "pngs": pngs, "write_tree_s": write_s, "s": real_s,
               "stage_s": stage_s, "launches": launches,
               "training_steps": steps}
        emit(out)
        for name, r in stages.items():
            numbers = {k: v for k, v in r.items()
                       if k not in ("stage", "status")}
            print(f"runbook stage {name}: {r['status']} "
                  f"{json.dumps(numbers, default=str)}", flush=True)
        for stage, sec in stage_s.items():
            print(f"runbook {stage}: {sec:.3f} s", flush=True)
        check_metric_table(table, "runbook, full width")
        wrong = [k for k in ("attention_fwd_seed", "attention_bwd",
                             "tsconv_bwd") if launches[k] != steps] + [
            k for k in ("attention_fwd", "tsconv_fwd") if not launches[k]]
        if (rc != (0 if report["ok"] else 1) or wrong or not finite
                or exported.get("eeg_features") != [n_train, 1024]
                or exported.get("eeg_features_test") != [n_test, 1024]
                or not out["prior_pickle"]
                or pngs != n_test
                or stages["generate"]["images"] != pngs
                or "top1_k200" not in stages["retrieval"]):
            raise RuntimeError(f"runbook at full width: launch counts "
                               f"wrong {wrong}, {out}")
    phase_s = time.perf_counter() - t_phase
    print(f"runbook phase 16: {phase_s:.3f} s", flush=True)
    emit({"phase": "phase16_total", "s": phase_s, "dry_run_s": dry_s,
          "full_width_s": real_s})
    return out


# ——— phase 17: stage-1 BatchNorm modes on the tsconv kernels, bf16 GIT ———

#: the first 16 hex digits of the SHA-256 of the tsconv forward's output
#: without an epilogue on :func:`tsconv_digest_inputs`, from the kernel as
#: it was before the epilogue existed (``scripts/ab_torch_kernels.py``'s
#: ``train_digest`` row of the parent checkout, which draws the same
#: inputs): the launch without an epilogue must still give these bits
TSCONV_FWD_SHA256 = {"bfloat16": "1cb4841841dce9d4",
                     "float32": "94f128b0902116e8"}
#: the epilogue modes the model takes: TSConv's 'gram2d' (scale, shift and
#: ELU on the fp32 sums) and 'gramfold' (the shift; the scale is in the taps)
EPILOGUE_MODES = {"scale_shift_elu": "gram2d", "shift": "gramfold"}
BN1_MODES = ("flax", "gram", "gram2d", "gramfold")
#: steps of epoch 0's permutation a mode trains for its step p50
BN1_STEPS = 12
#: the bf16 GIT decode: rows, new tokens, timed repeats
GIT_BF16_ROWS, GIT_BF16_TOKENS, GIT_BF16_REPS = 16, 25, 3


def tsconv_digest_inputs(torch, dtype):
    """(x (1024, 63, 250), w̃ (75, 40)) in ``dtype`` as
    ``scripts/ab_torch_kernels.py`` draws its ``train_digest`` tsconv case:
    a generator seeded ``SEED + 40`` gives the 25 taps (× 0.2), folded with
    the 51-wide pool, then x."""
    from eeg_image_decode_tpu_torch.ops.tsconv import fold_pool_into_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    w = torch.randn(25, 40, generator=g, device="cuda") * 0.2 + 0.0
    w = fold_pool_into_kernel(w, 51).to(dtype)
    x = torch.randn(TRAIN_BATCH, 63, 250, generator=g, device="cuda")
    return (x * 1.0 + 0.0).to(dtype), w


def sha16(torch, *tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def epilogue_kernels(torch) -> dict:
    """(a) The tsconv forward at the training shape (B 1024, 63 × 250, 75
    taps, 40 filters, stride 5), bf16 and fp32: without an epilogue its
    output bit-equal to the kernel before the epilogue
    (``TSCONV_FWD_SHA256``), and in each of ``EPILOGUE_MODES`` against its
    plain version (``tsconv_pool_reference`` with the same epilogue) on
    the BatchNorm of these inputs (``GramStage1BN.affine``: scale 1, bias
    0), a rerun bit-equal; each mode's ms, plain ms, device ms, bound and
    library yardstick (``torch.addmm`` of x2, the dense E and the shift
    for ``shift``; no one call adds ELU)."""
    from eeg_image_decode_tpu_torch.models.layers import GramStage1BN
    from eeg_image_decode_tpu_torch.ops.tsconv import (
        expand_folded_kernel,
        forward_design,
        tsconv_pool_fused,
        tsconv_pool_reference,
    )

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        x, w = tsconv_digest_inputs(torch, dtype)
        digest = sha16(torch, tsconv_pool_fused(x, w, 5))
        want = TSCONV_FWD_SHA256[dname]
        emit({"phase": "bn1_kernels", "mode": "none", "dtype": dname,
              "sha256": digest, "sha256_before_epilogue": want,
              "bit_equal": digest == want})
        if digest != want:
            raise RuntimeError(f"tsconv_fwd {dname} without an epilogue: "
                               f"digest {digest}, before the epilogue {want}")
        b, c, t = x.shape
        m, f = w.shape
        e = expand_folded_kernel(w, t, 5)
        p = e.shape[1] // f
        x2 = x.reshape(b * c, t)
        with torch.no_grad():
            mul, add = GramStage1BN(f).cuda().affine(x2, e, p, True)
        sz = x.element_size()
        for mode, impl in EPILOGUE_MODES.items():
            if mode == "shift":
                w_k = (w.float() * mul).to(dtype)
                kw = {"shift": add}
                e_k = expand_folded_kernel(w_k, t, 5)
                bias = add.repeat(p).to(dtype)
                library = lambda: torch.addmm(bias, x2, e_k)  # noqa: E731
            else:
                w_k, kw, library = w, {"scale": mul, "shift": add,
                                       "elu": True}, None
            kern = lambda: tsconv_pool_fused(x, w_k, 5, **kw)  # noqa: E731
            plain = lambda: tsconv_pool_reference(x, w_k, 5, **kw)  # noqa
            got, again, ref = kern(), kern(), plain()
            torch.cuda.synchronize()
            repeat = torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            # one rounding of the epilogue's fp32 value: 2 ulps of the
            # largest output in bf16; fp32 sums in another order
            tol = (2.0 ** -7 * top if dtype == torch.bfloat16
                   else 1e-4 * max(1.0, top))
            flops = 2 * b * c * p * m * f + 3 * b * c * p * f
            nbytes = (x.numel() + w.numel() + b * c * p * f) * sz + 2 * f * 4
            b_ms, b_by = bound(flops, nbytes, dname)
            row = {"phase": "bn1_kernels", "name": f"tsconv_fwd_{mode}",
                   "model_mode": impl, "dtype": dname,
                   "design": forward_design(dtype), "batch": TRAIN_BATCH,
                   "max_abs_err": err, "max_abs_out": top, "tolerance": tol,
                   "bit_identical_rerun": repeat,
                   "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                   "library_ms": cuda_ms(torch, library) if library else None,
                   "library": ("torch.addmm(shift, x2, E)" if library else
                               "none: no one call adds the scale and ELU"),
                   "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                   "bytes": nbytes, "device_ms": device_ms(torch, kern),
                   "plain_device_ms": device_ms(torch, plain)}
            if library:
                row["library_device_ms"] = device_ms(torch, library)
            emit(row)
            if not (repeat and torch.isfinite(got).all() and err <= tol):
                raise RuntimeError(f"tsconv_fwd_{mode} {dname}: rerun "
                                   f"bit-equal {repeat}, |Δ| {err} > {tol}")
            rows[(mode, dname)] = dict(
                row, replaces="eeg_image_decode_tpu/ops/tsconv.py:84",
                source="eeg_image_decode_tpu_torch/csrc/tsconv_fwd.cu")
    return rows


def bn1_stage_ms(torch, mode: str) -> dict:
    """Device ms of stage 1 + BN1 + ELU forward and backward in ``mode``
    (``TSConv.stage1`` at full width, B 1024, bf16, train mode; one
    cotangent), and of the product alone (the tsconv forward and backward
    kernels): their difference is BN1's."""
    from eeg_image_decode_tpu_torch.models.layers import TSConv
    from eeg_image_decode_tpu_torch.ops.tsconv import tsconv_pool_fused

    x, w = tsconv_digest_inputs(torch, torch.bfloat16)
    ts = TSConv(bn1_impl=mode).cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + 61)
    with torch.no_grad():
        ts.temporal_conv_kernel.copy_(
            torch.randn(25, 40, generator=g, device="cuda") * 0.2)
    xg = x.detach().requires_grad_()
    params = [ts.temporal_conv_kernel, ts.bn1.scale, ts.bn1.bias]
    y = ts.stage1(xg, True)
    gy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
    wg = w.detach().requires_grad_()

    def stage():
        return torch.autograd.grad(ts.stage1(xg, True), [xg, *params], gy)

    def product():
        return torch.autograd.grad(tsconv_pool_fused(xg, wg, 5), [xg, wg],
                                   gy)

    stage_ms, product_ms = device_ms(torch, stage), device_ms(torch, product)
    return {"stage1_bn1_elu_device_ms": stage_ms,
            "product_device_ms": product_ms,
            "bn1_device_ms": stage_ms - product_ms,
            "gram_mode": ts.gram_mode(xg)}


def bn1_modes_path(torch, card: str, train, test) -> dict:
    """(b) One ATM-S training step at B 1024 in bf16 under each
    ``tsconv_bn1`` (one seeded init, one batch, one dropout generator
    seed): the step's gradients against the ``'flax'`` step's (cosine over
    all parameters, and the largest relative L2 of one parameter,
    :func:`grad_rel_l2`) and against the same step in fp32 (``'flax'``,
    the reference: cosine, and the relative L2 of the temporal kernel's
    and BN1's gradients, where bf16 rounding meets BatchNorm's
    cancellation), then ``BN1_STEPS`` steps
    of epoch 0's permutation for the step p50, the launches counted from 0
    around each mode's steps (``tsconv_fwd_epilogue`` in 'gram2d' and
    'gramfold'), and BN1's device ms (:func:`bn1_stage_ms`). (c) The
    default ``ATMSConfig()`` on the card takes 'gram': its flag, and its
    step's BN1 running statistics bit-equal to the explicit 'gram' model's
    (and not to 'flax''s)."""
    from eeg_image_decode_tpu_torch.core.config import (
        ATMSConfig,
        ContrastiveTrainConfig,
    )
    from eeg_image_decode_tpu_torch.models.registry import build_encoder
    from eeg_image_decode_tpu_torch.ops import _build
    from eeg_image_decode_tpu_torch.train.contrastive import (
        ContrastiveTrainer,
        batch_loss,
        epoch_permutation,
    )

    tcfg = ContrastiveTrainConfig()
    perm = torch.as_tensor(epoch_permutation(
        train.n, TRAIN_BATCH, tcfg.seed, 0)[:BN1_STEPS], device="cuda")
    results, grads0, stats = {}, {}, {}
    for mode in (*BN1_MODES, "default", "fp32"):
        cfg = ATMSConfig() if mode == "default" else ATMSConfig(
            tsconv_bn1="flax" if mode == "fp32" else mode)
        dtype = torch.float32 if mode == "fp32" else torch.bfloat16
        model = build_encoder("atms", config=cfg, dtype=dtype,
                              device="cuda", seed=SEED)
        trainer = ContrastiveTrainer(model, tcfg, train, test, device="cuda")
        idx = perm[0].to(torch.int64)
        data = trainer.data
        batch = {"eeg": data.eeg[idx], "subject_ids": data.subject_ids[idx],
                 "img_feat": data.img_feat[data.img_idx[idx]],
                 "text_feat": data.text_feat[data.text_idx[idx]]}
        model.train()
        loss, _ = batch_loss(model, tcfg, batch, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 62))
        loss.backward()
        per_param = {k: q.grad.float().reshape(-1)
                     for k, q in model.named_parameters()}
        grads0[mode] = torch.cat(list(per_param.values()))
        bn1 = model.encoder.enc_eeg.bn1
        stats[mode] = (bn1.mean.clone(), bn1.var.clone())
        gram = model.encoder.enc_eeg.gram_mode(batch["eeg"])
        model.zero_grad(set_to_none=True)
        results[mode] = {"per_param": per_param, "loss0": loss.item(),
                         "gram_mode": gram}
        if mode in ("default", "fp32"):
            del trainer, model
            continue
        _build.reset_launches()
        out = trainer.epoch_fn(trainer.state, trainer.data, perm,
                               torch.Generator(device="cuda").manual_seed(
                                   tcfg.seed))
        launches = dict(_build.LAUNCHES)
        losses, step_ms = out["step_loss"].tolist(), out["step_ms"]
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"bn1 {mode}: non-finite loss {losses}")
        want_ep = BN1_STEPS if mode in ("gram2d", "gramfold") else 0
        if (launches["tsconv_fwd_epilogue"] != want_ep
                or launches["tsconv_bwd"] != BN1_STEPS):
            raise RuntimeError(f"bn1 {mode}: launches {launches}")
        results[mode].update(step_ms_p50=float(np.median(step_ms[3:])),
                             losses=losses, launches=launches)
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
    flax, ref = results["flax"]["per_param"], results["fp32"]["per_param"]
    ref_all = grads0["fp32"]
    rows = {}
    for mode in BN1_MODES:
        r = results[mode]
        a, b = grads0[mode], grads0["flax"]
        cos = float((a @ b) / (a.norm() * b.norm()))
        rel = grad_rel_l2(r["per_param"], flax)
        worst = max(rel, key=rel.get)
        rel32 = grad_rel_l2(r["per_param"], ref)
        tk = "encoder.enc_eeg.temporal_conv_kernel"
        row = {"phase": "bn1_modes", "card": card, "mode": mode,
               "dtype": "bfloat16", "batch": TRAIN_BATCH,
               "gram_mode": r["gram_mode"], "loss_step0": r["loss0"],
               "grad_cosine_vs_flax": cos, "worst_param_vs_flax": worst,
               "worst_rel_l2_vs_flax": rel[worst],
               "grad_cosine_vs_fp32_flax": float(
                   (a @ ref_all) / (a.norm() * ref_all.norm())),
               "temporal_kernel_rel_l2_vs_fp32_flax": rel32[tk],
               "bn1_rel_l2_vs_fp32_flax": max(rel32[f"encoder.enc_eeg.bn1.{n}"]
                                              for n in ("scale", "bias")),
               "step_ms_p50": r["step_ms_p50"], "steps": BN1_STEPS,
               "loss_first": r["losses"][0], "loss_last": r["losses"][-1],
               "launches": r["launches"], **bn1_stage_ms(torch, mode)}
        emit(row)
        if r["gram_mode"] != (mode != "flax") or not cos > 0.99:
            raise RuntimeError(f"bn1 {mode}: gram mode {r['gram_mode']}, "
                               f"gradient cosine against flax {cos}")
        rows[mode] = row
    same = [torch.equal(x, y) for x, y in zip(stats["default"],
                                              stats["gram"])]
    differ = [not torch.equal(x, y) for x, y in zip(stats["default"],
                                                    stats["flax"])]
    gram = results["default"]["gram_mode"]
    row = {"phase": "bn1_default", "config": "ATMSConfig()",
           "tsconv_bn1": ATMSConfig().tsconv_bn1, "gram_mode": gram,
           "bn1_stats_equal_gram": all(same),
           "bn1_stats_differ_from_flax": all(differ)}
    emit(row)
    if not (gram and all(same) and all(differ)):
        raise RuntimeError(f"the default config did not take 'gram': {row}")
    return rows


def git_bf16_path(torch, card: str) -> dict:
    """(d) GIT at ``git_large_coco()`` widths from seeded weights, in bf16
    and fp32 (the same weights): a 16-row greedy decode of 25 tokens from
    one draw of visual tokens, each decode's p50 over ``GIT_BF16_REPS``
    (host clock, synced), and the share of the bf16 ids equal to the fp32
    ids position for position."""
    from eeg_image_decode_tpu_torch.models.git_caption import (
        GITCaptioner,
        GITConfig,
    )

    cfg = GITConfig.git_large_coco()
    g = torch.Generator(device="cuda").manual_seed(SEED + 63)
    vis = torch.randn(GIT_BF16_ROWS, cfg.num_visual_tokens, cfg.visual_dim,
                      generator=g, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.device("cuda"):
            git = GITCaptioner(cfg, dtype=dtype).init_random(SEED).eval()
        ids = git.generate(vis, max_new_tokens=GIT_BF16_TOKENS)
        times = []
        for _ in range(GIT_BF16_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = git.generate(vis, max_new_tokens=GIT_BF16_TOKENS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(ids, again):
            raise RuntimeError(f"GIT {dtype}: two decodes differ")
        out[str(dtype).split(".")[-1]] = (ids.cpu().numpy(),
                                          float(np.median(times)))
        del git
    ids32, ms32 = out["float32"]
    ids16, ms16 = out["bfloat16"]
    new = slice(1, None)
    share = float((ids16[:, new] == ids32[:, new]).mean())
    rows_equal = int((ids16 == ids32).all(axis=1).sum())
    row = {"phase": "git_bf16", "card": card, "config": "git_large_coco",
           "rows": GIT_BF16_ROWS, "new_tokens": GIT_BF16_TOKENS,
           "decode_ms_p50_bf16": ms16, "decode_ms_p50_fp32": ms32,
           "ids_equal_share": share, "rows_equal": rows_equal,
           "ids_in_vocab": bool((ids16 >= 0).all()
                                and (ids16 < cfg.vocab_size).all())}
    emit(row)
    if not row["ids_in_vocab"] or ids16.shape != ids32.shape:
        raise RuntimeError(f"bf16 GIT decode: {row}")
    return row


def bn1_gram_paths(torch, card: str, train, test) -> dict:
    """Phase 17: (a) the epilogue kernels, (b)-(c) the four stage-1
    BatchNorm modes and the default on phase 4's split on the card, (d)
    the bf16 GIT decode."""
    t0 = time.perf_counter()
    kernels = epilogue_kernels(torch)
    modes = bn1_modes_path(torch, card, train, test)
    gc.collect()
    torch.cuda.empty_cache()
    git = git_bf16_path(torch, card)
    emit({"phase": "phase17_total", "s": time.perf_counter() - t0})
    return {"kernels": kernels, "modes": modes, "git": git}


# ——— phase 18: the full-size rehearsals ———

#: phase 18 (b)'s epochs: cold, then resumed to (THINGS-EEG's full subject)
FULLSCALE_EPOCHS = (2, 4)


def fullsize_path(torch, card: str) -> list:
    """Phase 18 (a): every published checkpoint's grammar synthesized,
    converted on the host and run in bf16 on the card
    (``scripts/rehearse_fullsize_torch.py``, each leg raising on a
    failure)."""
    fullsize = load_script("rehearse_fullsize_torch")
    rows = []
    for name in fullsize.LEGS:
        row = {"phase": "fullsize", "card": card,
               **fullsize.run_leg(name, "cuda")}
        emit(row)
        rows.append(row)
    return rows


def fullscale_path(torch, card: str, main_launches: dict) -> dict:
    """Phase 18 (b): ``train-retrieval`` on one subject at THINGS-EEG's
    stored size through the CLI (``scripts/rehearse_fullscale_torch.py``),
    its launches counted into the main path."""
    from eeg_image_decode_tpu_torch.ops import _build

    fullscale = load_script("rehearse_fullscale_torch")
    epochs, resume = FULLSCALE_EPOCHS
    _build.reset_launches()
    report = fullscale.main(["--device", "cuda", "--epochs", str(epochs),
                             "--resume-epochs", str(resume)])
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    steps = report["training_steps"]
    wrong = [k for k in ("attention_fwd_seed", "attention_bwd",
                         "tsconv_bwd") if launches[k] != steps] + [
        k for k in ("attention_fwd", "tsconv_fwd") if not launches[k]]
    cold, warm = report["cold"], report["resumed"]
    row = {"phase": "fullscale_cli", "card": card,
           "epochs": report["results_csv_epochs"],
           "write_s": report["write"]["s"],
           "pickle_write_s": {k: report["write"][k]["write_s"]
                              for k in ("training", "test")},
           "ingest_cold_s": cold["ingest_s"][0],
           "ingest_sidecar_s": warm["ingest_s"][0],
           "epoch_s": [e["s"] for e in cold["epochs"] + warm["epochs"]],
           "evaluate_s": (cold["evaluate_s"] or []) + (warm["evaluate_s"]
                                                       or []),
           "checkpoint_s": (cold["checkpoint_s"] or [])
           + (warm["checkpoint_s"] or []),
           "export_s": warm["export_s"], "cli_evaluate_s":
           report["evaluate"]["s"], "step_ms_p50": report["step_ms_p50"],
           "samples_per_s": report["samples_per_s"],
           "resident_gb": cold["resident_gb"],
           "peak_device_gb": max(cold["peak_device_gb"],
                                 warm["peak_device_gb"]),
           "host_peak_rss_gb": max(cold["host_peak_rss_gb"],
                                   warm["host_peak_rss_gb"]),
           "bytes": report["bytes"],
           "resume_max_abs_dloss": warm["max_abs_dloss"],
           "resume_bit_equal": warm["bit_equal"],
           "resume_tolerance": warm["resume_tol"],
           "evaluate_equals_trainer": report["evaluate"]["equal"],
           "sidecar_reads": report["sidecar_reads"],
           "training_steps": steps, "launches": launches}
    emit(row)
    if wrong or not report["ok"]:
        raise RuntimeError(f"full-scale CLI: launches wrong {wrong}, {row}")
    return row


def rehearsal_paths(torch, card: str, main_launches: dict) -> dict:
    """Phase 18: (a) the converted full-size models, (b) the full-scale
    ``train-retrieval``."""
    t0 = time.perf_counter()
    legs = fullsize_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    cli_row = fullscale_path(torch, card, main_launches)
    emit({"phase": "phase18_total", "s": time.perf_counter() - t0})
    return {"legs": legs, "cli": cli_row}


# ——— phase 19: the long trajectories on the card, the walkthrough ———

#: phase 19 (a): ``PriorConfig()``'s widths, 30 epochs of 4 steps at B 1024
TRAJ_PRIOR = {"epochs": 30, "steps": 4, "batch": 1024}
#: phase 19 (b): reduced stages over 8 epochs, then the published widths
#: for one epoch of 2 steps (a full-size step takes seconds on the host)
TRAJ_LOWLEVEL = (
    {"name": "reduced", "stages": (128, 64, 32, 16, 16, 16), "time_proj": 32,
     "n": 128, "batch": 16, "epochs": 8},
    {"name": "full", "stages": (1024, 512, 256, 128, 64, 32),
     "time_proj": 128, "n": 16, "batch": 8, "epochs": 1})


def prior_trajectory_path(torch, card: str) -> dict:
    """Phase 19 (a): ``PriorPipe`` at ``PriorConfig()``'s widths over the
    injected epochs of ``scripts/parity_torch_prior_trajectory.py`` (its
    warmup the published share, then the cosine), on the card without TF32
    against the same run on the host's CPU from one seeded init; both
    trained pipes' CFG samples under shared noise at guidance 5.0 and 0.
    The script's bands, which hold the port to JAX on the CPU."""
    ppt = load_script("parity_torch_prior_trajectory")
    epochs, steps, batch = (TRAJ_PRIOR[k] for k in ("epochs", "steps",
                                                     "batch"))
    widths = ppt.full_widths()
    cfg = ppt.prior_config(widths, epochs * steps)
    n = steps * batch
    c, h = ppt.make_data(n, cfg.embed_dim, cfg.cond_dim, SEED)
    draws = ppt.draw_shared(n, batch, epochs, cfg.embed_dim,
                            cfg.num_train_timesteps, cfg.cond_dropout_prob,
                            SEED)
    init = ppt.port_init(cfg, SEED)
    noise = ppt.sample_noise(ppt.SAMPLE_ROWS, cfg.embed_dim,
                             ppt.SAMPLE_STEPS, SEED)
    cond = c[:ppt.SAMPLE_ROWS]
    t0 = time.perf_counter()
    cpu = ppt.run_port_injected(init, cfg, c, h, draws, device="cpu")
    cpu_samples = ppt.port_samples(cpu["pipe"], cond, noise)
    cpu_s = time.perf_counter() - t0
    with tf32_off(torch):
        t0 = time.perf_counter()
        gpu = ppt.run_port_injected(init, cfg, c, h, draws, device="cuda")
        gpu_samples = ppt.port_samples(gpu["pipe"], cond, noise)
        card_s = time.perf_counter() - t0
    rel = ppt.deviations(gpu["losses"], cpu["losses"])
    samples = ppt.compare_samples(gpu_samples, cpu_samples)
    row = {"phase": "prior_trajectory", "card": card, "dtype": "float32",
           "tf32": False, "widths": widths, "pairs": n, "batch": batch,
           "epochs": epochs, "total_steps": epochs * steps,
           "warmup_steps": cfg.warmup_steps,
           "card_losses": gpu["losses"], "cpu_losses": cpu["losses"],
           "rel_loss_dev": rel, "max_rel_loss_dev": max(rel),
           "max_param_diff": ppt.max_param_diff(
               gpu["pipe"].model.state_dict(),
               cpu["pipe"].model.state_dict()),
           "clip_steps": {"card": gpu["clip_steps"],
                          "cpu": cpu["clip_steps"]},
           "samples": samples,
           "step_ms_p50": float(np.median(gpu["step_ms"][3:])),
           "card_s": card_s, "cpu_s": cpu_s}
    emit(row)
    bad = ppt.loss_failures(rel) + ppt.sample_failures(samples)
    if bad or gpu["losses"][-1] >= gpu["losses"][0]:
        raise RuntimeError(f"prior trajectory, card against CPU: {bad}, "
                           f"{row}")
    return row


def lowlevel_trajectory_path(torch, card: str) -> list:
    """Phase 19 (b): ``LowLevelTrainer`` (fp32, cuDNN's ``CUDNN_FLAGS``,
    TF32 off) on the card against the same trainer on the host's CPU from
    one seeded init, each through its own ``train()``: reduced stages over
    8 epochs, then the published widths (143 M parameters) for 2 steps.
    The bands of ``scripts/parity_torch_lowlevel_trajectory.py``."""
    plt = load_script("parity_torch_lowlevel_trajectory")
    eval_eeg, eval_lat = plt.make_data(32, SEED + 99)
    target = np.moveaxis(eval_lat, 1, -1)
    rows = []
    for leg in TRAJ_LOWLEVEL:
        kw = {k: leg[k] for k in ("epochs", "batch", "stages", "time_proj")}
        eeg, lat = plt.make_data(leg["n"], SEED)
        init = plt.port_model(leg["stages"], leg["time_proj"]) \
            .reset_parameters(SEED).state_dict()
        t0 = time.perf_counter()
        cpu_l, cpu_steps, cpu_t = plt.run_port(init, eeg, lat, lr=1e-3,
                                               seed=7, **kw)
        cpu_pred = plt.predict_port(cpu_t, eval_eeg)
        cpu_s = time.perf_counter() - t0
        with tf32_off(torch):
            t0 = time.perf_counter()
            gpu_l, gpu_steps, gpu_t = plt.run_port(init, eeg, lat, lr=1e-3,
                                                   seed=7, device="cuda",
                                                   **kw)
            gpu_pred = plt.predict_port(gpu_t, eval_eeg)
            card_s = time.perf_counter() - t0
        rel = plt.deviations(gpu_l, cpu_l)
        agree = plt.prediction_agreement(gpu_pred, cpu_pred, target)
        param_diff, stat_diff = plt.state_failures(
            gpu_t.model.state_dict(), cpu_t.model.state_dict())
        row = {"phase": "lowlevel_trajectory", "card": card,
               "leg": leg["name"], "dtype": "float32", "tf32": False,
               "params": sum(p.numel() for p in gpu_t.model.parameters()),
               **{k: leg[k] for k in ("n", "batch", "epochs", "stages",
                                      "time_proj")},
               "card_losses": gpu_l, "cpu_losses": cpu_l,
               "rel_loss_dev": rel, "last_epoch_step_rel_dev":
               plt.deviations(gpu_steps.tolist(), cpu_steps.tolist()),
               "max_param_diff": param_diff,
               "max_stat_rel_diff": stat_diff, "agreement": agree,
               "card_step_ms": gpu_t.last_steps["step_ms"],
               "card_s": card_s, "cpu_s": cpu_s}
        emit(row)
        bad = plt.failures(rel, agree)
        if bad:
            raise RuntimeError(f"low-level trajectory ({leg['name']}), card "
                               f"against CPU: {bad}, {row}")
        rows.append(row)
        del cpu_t, gpu_t
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def load_example():
    """``examples/end_to_end_torch.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "end_to_end_torch.py")
    spec = importlib.util.spec_from_file_location("end_to_end_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_path(torch, card: str, main_launches: dict) -> dict:
    """Phase 19 (c): the port's walkthrough on the card; NICE's steps and
    evaluations launch the tsconv forward and backward kernels, counted
    into the main path."""
    from eeg_image_decode_tpu_torch.ops import _build

    example = load_example()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = example.main(["--device", "cuda"])
    s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    add_launches(main_launches, launches)
    printed = out.getvalue().splitlines()
    row = {"phase": "example", "card": card, "s": s, **res,
           "printed_lines": len(printed), "launches": launches}
    emit(row)
    numbers = [*res["retrieval"].values(),
               *res["generated_retrieval"].values(),
               *res["metrics"].values(), res["prior_loss"],
               *res["image_range"]]
    if (not launches["tsconv_fwd"] or not launches["tsconv_bwd"]
            or not all(np.isfinite(numbers))
            or res["images"] != [4, 16, 16, 3]
            or not all(0.0 <= v <= 1.0 for v in res["image_range"])
            or len(res["captions"]) != 4
            or json.loads(printed[-1])["images"] != res["images"]):
        raise RuntimeError(f"end-to-end example on the card: {row}")
    return row


def trajectory_paths(torch, card: str, main_launches: dict) -> dict:
    """Phase 19: (a) the prior's and (b) the low-level trainer's long
    trajectories on the card against the host's CPU, (c) the walkthrough."""
    t0 = time.perf_counter()
    prior = prior_trajectory_path(torch, card)
    lowlevel = lowlevel_trajectory_path(torch, card)
    example = example_path(torch, card, main_launches)
    phase_s = time.perf_counter() - t0
    print(f"trajectories and walkthrough, phase 19: {phase_s:.3f} s",
          flush=True)
    emit({"phase": "phase19_total", "s": phase_s, "prior_s":
          prior["card_s"] + prior["cpu_s"], "lowlevel_s": sum(
              r["card_s"] + r["cpu_s"] for r in lowlevel),
          "example_s": example["s"]})
    return {"prior": prior, "lowlevel": lowlevel, "example": example}


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
        if ("registers" in line or "properties for" in line
                or line.startswith("==")):
            print("ptxas:", line.strip(), flush=True)

    # the bfloat16 designs of every kernel must run on the tensor cores
    tensor_core = _build.count_sass(("HMMA", "HGMMA"), TENSOR_CORE_KERNELS)
    emit({"phase": "setup", "check": "cuobjdump -sass: HMMA/HGMMA "
          "instructions in the bfloat16 attention, tsconv and projection "
          "kernels", "tensor_core_instructions": tensor_core})
    if not all(tensor_core.values()):
        raise RuntimeError(f"a bfloat16 kernel holds no tensor-core "
                           f"instruction: {tensor_core}")

    kernels = check_kernels(torch)
    kernels.update(check_training_kernels(torch))

    train, test = make_synthetic_retrieval_data(
        n_classes=200, images_per_class=1, train_reps=2, seed=SEED,
        device="cpu")
    # 600 × 63 × 250 request rows; the gallery: 200 × 1024, unit rows
    eeg = np.concatenate([test.eeg.numpy(), train.eeg.numpy()])
    sids = np.random.default_rng(SEED).integers(0, 10, len(eeg)).astype(
        np.int32)
    gallery = test.img_features.numpy()
    serve_rows = [
        serve_path(torch, "default_head", False, eeg, sids, gallery),
        serve_path(torch, "fused_projection", True, eeg, sids, gallery),
    ]

    del train, test, eeg
    t0 = time.perf_counter()
    train, test = make_synthetic_retrieval_data(
        n_classes=1654, n_test_classes=200, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    train_row, trainer = train_path(torch, card, train, test, data_s)
    grad_check(torch, trainer)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_prior_")
    export_launches: dict = {}
    pairs = prior_pairs_path(torch, trainer, export_launches, work.name)
    encoder = trainer.model  # phase 10 serves the trained encoder
    del trainer

    # launches on the main paths: the serving requests, the training epoch
    # and the evaluation, the export of the prior's pairs, the fused-head
    # joint run and the CLI (each counted from 0). The seeded mask draws
    # are device functions of the seeded forwards and the backwards, not
    # launches.
    main_path = {k: sum(r["launches"][k] for r in serve_rows)
                 + train_row["launches_train"][k]
                 + train_row["launches_eval"][k]
                 for k in _build.LAUNCHES}
    add_launches(main_path, export_launches)
    fused_joint_path(torch, card, train, test, train_row["step_ms_p50"],
                     main_path)
    # phase 17 runs here, on phase 4's split, while torch.profiler still
    # traces the port's kernels (late in a run its traces came back
    # without them); its own launches are not the main path's
    bn1 = bn1_gram_paths(torch, card, train, test)
    eeg_test = test.eeg[:40].cpu().numpy()
    # phase 6's tree and phase 4's split stay for phase 13
    cli_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    tmp = cli_dir.name
    _, run_dir, root, feats = cli_path(torch, main_path, tmp)
    export_path(torch, run_dir, root, feats, main_path)
    prior_cli_path(torch, os.path.join(tmp, "cli_pairs.npz"), tmp)
    vae_pkl = os.path.join(tmp, "vae.pkl")
    emit({"phase": "vae_pickle", **write_vae_pickle(torch, vae_pkl)})
    lowlevel_cli_path(torch, root, tmp, vae_pkl)
    generate_cli_path(torch, tmp, os.path.join(tmp, "cli_pairs.npz"),
                      os.path.join(tmp, "prior_cli", "diffusion_prior.pkl"),
                      vae_pkl)
    caption_cli_path(torch, tmp, os.path.join(tmp, "cli_pairs.npz"),
                     os.path.join(tmp, "prior_cli", "diffusion_prior.pkl"),
                     feats)
    metric_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_metrics_")
    pickles = write_metric_pickles(torch, metric_dir.name)
    emit({"phase": "metric_pickles", **pickles})
    metrics_cli_path(torch, card, tmp, pickles)
    features_path(torch, card)
    with work:
        _, prior = prior_path(torch, card, pairs, work.name)
        del pairs
        lowlevel_path(torch, card, train.eeg, work.name)
    generation_path(torch, card, encoder, prior, eeg_test, main_path)
    gc.collect()  # the generator's 6 GB, held in the daemon's cycles
    torch.cuda.empty_cache()
    caption_path(torch, card, encoder, prior, eeg_test, main_path)
    adapter_path(torch, card)
    del encoder, prior
    gc.collect()
    torch.cuda.empty_cache()
    metrics_path(torch, card, pickles)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for name in ZOO:
        zoo_train_path(torch, card, name, train, test, main_path)
    # phase 14 streams phase 4's split from the host
    train_host = dataclasses.replace(train, **{
        f: getattr(train, f).cpu() for f in (
            "eeg", "labels", "subject_ids", "img_idx", "text_idx",
            "img_features", "text_features")})
    del train
    with cli_dir:
        zoo_cli_path(torch, root, feats, tmp, main_path)
        emit({"phase": "zoo_total", "s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        preprocess_cli_path(torch, tmp, feats, main_path)
        meg_cli_path(torch, tmp)
    streaming_path(torch, card, train_host, test, main_path)
    gc.collect()
    torch.cuda.empty_cache()
    preprocess_full_path(torch, card)
    emit({"phase": "phase14_total", "s": time.perf_counter() - t0})

    # phase 15 trains phase 4's split from the host copy over a mesh
    scale_out_paths(torch, card, train_host, test, main_path)
    del train_host, test
    gc.collect()
    torch.cuda.empty_cache()

    # phase 16 runs the acceptance runbook with phase 12's metric pickles
    with metric_dir:
        runbook_path(pickles, main_path)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 18: the full-size rehearsals, timed with CUDA events (no
    # profiler: late in a run its traces lose the port's kernels)
    rehearsal_paths(torch, card, main_path)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 19: the long trajectories and the walkthrough (CUDA events)
    trajectory_paths(torch, card, main_path)
    gc.collect()
    torch.cuda.empty_cache()

    line = []
    for name in ("attention_fwd", "attention_fwd_seed", "attention_bwd",
                 "tsconv_fwd", "tsconv_bwd", "projection_fwd",
                 "projection_fwd_seed", "projection_bwd"):
        k = kernels[(name, "bfloat16")]
        if not main_path[name]:
            raise RuntimeError(f"{name} was not launched on the main path")
        line.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": main_path[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            **{key: k[key] for key in ("design", "device_ms",
                                       "plain_device_ms") if key in k},
        })
    # the forward's epilogue modes: launched by phase 17's 'gram2d' and
    # 'gramfold' steps, each counted from 0 around its mode's steps
    for mode, impl in EPILOGUE_MODES.items():
        k = bn1["kernels"][(mode, "bfloat16")]
        launches = bn1["modes"][impl]["launches"]["tsconv_fwd_epilogue"]
        if not launches:
            raise RuntimeError(f"tsconv_fwd_{mode} was not launched on "
                               f"'{impl}''s path")
        line.append({
            "name": f"tsconv_fwd_{mode}", "route": "cuda",
            "source": k["source"], "replaces": k["replaces"],
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "design": k["design"],
            "device_ms": k["device_ms"],
            "plain_device_ms": k["plain_device_ms"],
            "path": f"phase 17, TSConv(bn1_impl='{impl}')"})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:   # one rank of phase 15's subprocesses
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
