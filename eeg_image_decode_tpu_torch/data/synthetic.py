"""Synthetic THINGS-EEG-shaped data (counterpart of ``eeg_image_decode_tpu/data/synthetic.py``).

Real THINGS-EEG + CLIP caches aren't shipped with either repo, so every
integration test and the throughput benchmark run on synthetic data with the
exact real shapes (train (n_cls*10*4, 63, 250), test (200, 63, 250), CLIP dim
1024). The EEG carries a low-rank class signature projected through a random
mixing matrix plus noise, and the "CLIP" features are unit-norm class anchors
with per-image jitter — so contrastive training genuinely learns and k-way
retrieval rises above chance, validating the full pipeline end-to-end.
"""

from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np
import torch

from eeg_image_decode_tpu_torch.data.things_eeg import EEGRetrievalData
from eeg_image_decode_tpu_torch.utils.device import resolve_device


def make_synthetic_retrieval_data(
    n_classes: int = 40,
    images_per_class: int = 10,
    train_reps: int = 4,
    n_channels: int = 63,
    n_timepoints: int = 250,
    clip_dim: int = 1024,
    n_test_classes: int | None = None,
    snr: float = 1.0,
    seed: int = 20200220,
    subject_id: int = 1,
    device: str | torch.device | None = None,
) -> tuple[EEGRetrievalData, EEGRetrievalData]:
    """Returns (train, test) splits sharing class structure, as tensors on
    ``device`` (default: the CUDA card, raising without one; pass
    ``device="cpu"`` for the CPU).

    Test classes are the first ``n_test_classes`` (default: all) with fresh
    EEG noise, mirroring the real setup where test EEG is averaged over many
    repetitions (lower noise → we draw one clean-ish epoch).

    The JAX package's recipe (class anchors, a rank-16 class signature mixed
    into channel × time, unit-variance noise), drawn with a
    ``torch.Generator`` on ``device``, so a split of one subject's real size
    (1654 classes: 66,160 × 63 × 250 fp32, 4.2 GB) never passes through the
    host. The draws differ from the numpy recipe's; the shapes, scales and
    class structure are the same.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    if n_test_classes is None:
        n_test_classes = n_classes

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def unit(a):
        return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)

    # class anchors in CLIP space (unit norm); per-image features: anchor +
    # jitter, renormalized (train targets)
    anchors = unit(randn(n_classes, clip_dim))
    img_feats = unit(anchors[:, None, :]
                     + 0.1 * randn(n_classes, images_per_class, clip_dim))
    img_feats = img_feats.reshape(n_classes * images_per_class, clip_dim)
    text_feats = unit(anchors + 0.05 * randn(n_classes, clip_dim))
    # latent class signatures mixed into channel×time EEG
    rank = 16
    class_latent = randn(n_classes, rank)
    mix = randn(rank, n_channels * n_timepoints) / math.sqrt(rank)

    def epochs(labels: torch.Tensor, noise_scale: float) -> torch.Tensor:
        out = torch.empty((len(labels), n_channels * n_timepoints),
                          device=dev)
        for lo in range(0, len(labels), 8192):  # bounded temporaries
            hi = min(lo + 8192, len(labels))
            out[lo:hi] = snr * (class_latent[labels[lo:hi]] @ mix) \
                + noise_scale * randn(hi - lo, n_channels * n_timepoints)
        return out.reshape(len(labels), n_channels, n_timepoints)

    i32 = dict(dtype=torch.int32, device=dev)
    n_train = n_classes * images_per_class * train_reps
    train_labels = torch.arange(n_classes, **i32).repeat_interleave(
        images_per_class * train_reps)
    local = torch.arange(n_train, **i32)
    train = EEGRetrievalData(
        eeg=epochs(train_labels.long(), 1.0),
        labels=train_labels,
        subject_ids=torch.full((n_train,), subject_id, **i32),
        img_idx=local // train_reps,
        text_idx=local // (images_per_class * train_reps),
        img_features=img_feats,
        text_features=text_feats,
        n_classes=n_classes,
        images_per_class=images_per_class,
    )
    test_labels = torch.arange(n_test_classes, **i32)
    # test features: the held-out image of each class ≈ anchor + fresh jitter
    test_img = unit(anchors[:n_test_classes]
                    + 0.1 * randn(n_test_classes, clip_dim))
    test = EEGRetrievalData(
        eeg=epochs(test_labels.long(), 0.25),  # rep-averaged → less noise
        labels=test_labels,
        subject_ids=torch.full((n_test_classes,), subject_id, **i32),
        img_idx=torch.arange(n_test_classes, **i32),
        text_idx=torch.arange(n_test_classes, **i32),
        img_features=test_img,
        text_features=text_feats[:n_test_classes],
        n_classes=n_test_classes,
        images_per_class=1,
    )
    return train, test


def write_synthetic_things_tree(
    root: str,
    subjects: tuple[str, ...] = ("sub-01", "sub-02"),
    *,
    n_classes: int = 20,
    n_test_classes: int = 10,
    train_reps: int = 4,
    test_reps: int = 4,
    seed: int = 20200220,
) -> str:
    """Write a THINGS-EEG-shaped tree under ``root`` and return the path of
    its CLIP feature file: what ``cli train-retrieval`` and ``evaluate``
    read, at any size, from a numpy seed.

    Per subject, ``<root>/<sub>/preprocessed_eeg_{training,test}.npy``: the
    pickled dict of the reference's preprocessing output (``preprocessed_
    eeg_data`` (conditions, reps, C, T), ``ch_names``, ``times`` with the 50
    pre-stimulus samples the loader skips). ``<root>/features.npz`` holds
    ``img_features`` (n_classes · images_per_class, D), ``text_features``
    and the disjoint test concepts' ``img_features_test`` /
    ``text_features_test``. Epochs are 63 × 250 and features 1024 wide,
    what the CLI's full-width model takes; a train class has 10 images,
    the count the loader reads the EEG layout at (``train_reps`` is free:
    ``--train-reps``). The EEG is the recipe of
    :func:`make_synthetic_retrieval_data`: a rank-16 class signature shared
    by the subjects, a per-subject gain, and unit noise."""
    images_per_class, n_channels, n_timepoints, clip_dim = 10, 63, 250, 1024
    rng = np.random.default_rng(seed)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    n_all = n_classes + n_test_classes  # test concepts are disjoint
    anchors = unit(rng.normal(size=(n_all, clip_dim)))
    img = unit(anchors[:n_classes, None, :] + 0.1 * rng.normal(
        size=(n_classes, images_per_class, clip_dim)))
    feats = {
        "img_features": img.reshape(-1, clip_dim),
        "text_features": unit(anchors[:n_classes] + 0.05 * rng.normal(
            size=(n_classes, clip_dim))),
        "img_features_test": unit(anchors[n_classes:] + 0.1 * rng.normal(
            size=(n_test_classes, clip_dim))),
        "text_features_test": unit(anchors[n_classes:] + 0.05 * rng.normal(
            size=(n_test_classes, clip_dim))),
    }
    rank = 16
    latent = rng.normal(size=(n_all, rank))
    mix = rng.normal(size=(rank, n_channels * n_timepoints)) / math.sqrt(rank)
    times = np.concatenate([
        np.linspace(-0.2, 0.0, 50, endpoint=False),
        np.linspace(0.0, 1.0, n_timepoints)])

    def epochs(classes, reps, gain, noise):
        signal = (latent[classes] @ mix).reshape(
            len(classes), 1, n_channels, n_timepoints)
        return (gain * signal + noise * rng.normal(
            size=(len(classes), reps, n_channels, n_timepoints))
        ).astype(np.float32)

    for i, sub in enumerate(subjects):
        gain = 1.0 + 0.1 * i
        train_cls = np.repeat(np.arange(n_classes), images_per_class)
        test_cls = np.arange(n_classes, n_all)
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for name, data in (
                ("preprocessed_eeg_training.npy",
                 epochs(train_cls, train_reps, gain, 1.0)),
                ("preprocessed_eeg_test.npy",
                 epochs(test_cls, test_reps, gain, 0.5))):
            with open(os.path.join(root, sub, name), "wb") as f:
                pickle.dump({"preprocessed_eeg_data": data,
                             "ch_names": [f"ch{c}" for c in range(n_channels)],
                             "times": times}, f, protocol=4)
    path = os.path.join(root, "features.npz")
    np.savez(path, **{k: v.astype(np.float32) for k, v in feats.items()})
    return path


def make_synthetic_raw_session(
    n_conditions: int,
    reps: int,
    *,
    images_per_class: int = 10,
    class_offset: int = 0,
    target_every: int = 20,
    seed: int = 20200220,
    topo_seed: int | None = None,
) -> dict:
    """One raw THINGS-EEG recording partition drawn from a numpy seed, as
    the reference's ``raw_eeg_{training,test}.npy`` holds it:
    ``{"raw_eeg_data": (64, n_samples) float32 at 1000 Hz, "ch_names": the
    63 EEG channels in a seeded order plus "stim", "sfreq": 1000.0}``.

    Events: conditions ``1 … n_conditions`` ``reps`` times each, in a seeded
    order every 200 ms (THINGS-EEG2's RSVP at 5 Hz), with a target
    event (99999) inserted after every ``target_every``-th; 1 s of lead-in
    and 1.5 s after the last onset. The EEG: unit noise, a slow drift per
    channel (what the baseline removes) and, from each onset, an evoked
    response whose topography is the class's (class ``class_offset +
    (condition − 1) // images_per_class``; drawn from ``(topo_seed,
    class)``, ``topo_seed`` defaulting to ``seed``, so that sessions and
    partitions given one ``topo_seed`` share it)."""
    from eeg_image_decode_tpu_torch.preprocess.epoching import (
        CHANNEL_ORDER,
        TARGET_EVENT,
    )

    rng = np.random.default_rng(seed)
    values = list(rng.permutation(np.repeat(
        np.arange(1, n_conditions + 1), reps)))
    for k in range(len(values) // target_every, 0, -1):
        values.insert(k * target_every, TARGET_EVENT)
    sfreq, soa = 1000, 200
    onsets = sfreq + soa * np.arange(len(values))
    n_samples = int(onsets[-1] + 1.5 * sfreq)
    n_ch = len(CHANNEL_ORDER)
    data = rng.standard_normal((n_ch + 1, n_samples), dtype=np.float32)
    t = np.arange(n_samples, dtype=np.float32) / sfreq
    data[:n_ch] += np.sin(2 * np.pi * 0.1 * t[None, :]
                          + rng.uniform(0, 2 * np.pi, (n_ch, 1))
                          ).astype(np.float32) * 3.0
    evoked_len = int(0.6 * sfreq)
    wave = np.sin(np.pi * np.arange(evoked_len) / evoked_len).astype(
        np.float32)
    topo: dict[int, np.ndarray] = {}
    stim = np.zeros(n_samples, np.float32)
    for onset, v in zip(onsets, values):
        stim[onset] = v
        if v == TARGET_EVENT:
            continue
        cls = class_offset + (int(v) - 1) // images_per_class
        if cls not in topo:
            topo[cls] = np.random.default_rng((
                seed if topo_seed is None else topo_seed, cls)).normal(
                size=n_ch).astype(np.float32)
        data[:n_ch, onset:onset + evoked_len] += topo[cls][:, None] * wave
    data[n_ch] = stim
    order = rng.permutation(n_ch)
    return {"raw_eeg_data": np.concatenate([data[order], data[n_ch:]]),
            "ch_names": [CHANNEL_ORDER[i] for i in order] + ["stim"],
            "sfreq": float(sfreq)}


def write_synthetic_raw_tree(
    project_dir: str,
    sub: int = 1,
    n_ses: int = 2,
    *,
    n_train_conditions: int = 300,
    n_test_conditions: int = 20,
    train_reps: int = 2,
    test_reps: int = 20,
    images_per_class: int = 10,
    seed: int = 20200220,
) -> str:
    """Write the raw tree ``cli preprocess`` reads and return its
    directory: ``<project_dir>/Raw_data/sub-XX/ses-YY/raw_eeg_{training,
    test}.npy``, one :func:`make_synthetic_raw_session` per file (every
    session holds every condition, so the training merge gives ``n_ses ·
    train_reps`` reps). The first session's files are ``np.save`` of the
    dict (a 0-d object array), the others the dict pickled, the two forms
    the reader takes. Test conditions are classes of their own, after the
    ``n_train_conditions / images_per_class`` training classes."""
    n_train_classes = n_train_conditions // images_per_class
    out = os.path.join(project_dir, "Raw_data", f"sub-{sub:02d}")
    for ses in range(1, n_ses + 1):
        d = os.path.join(out, f"ses-{ses:02d}")
        os.makedirs(d, exist_ok=True)
        for k, (part, n_cond, reps, ipc, off) in enumerate((
                ("training", n_train_conditions, train_reps,
                 images_per_class, 0),
                ("test", n_test_conditions, test_reps, 1, n_train_classes))):
            raw = make_synthetic_raw_session(
                n_cond, reps, images_per_class=ipc, class_offset=off,
                seed=seed + 1000 * sub + 10 * ses + k, topo_seed=seed)
            path = os.path.join(d, f"raw_eeg_{part}.npy")
            if ses == 1:
                np.save(path, raw, allow_pickle=True)
            else:
                with open(path, "wb") as f:
                    pickle.dump(raw, f, protocol=4)
    return out


def write_synthetic_clip_vocab(directory: str, texts: list[str], *,
                               vocab_size: int = 49408) -> tuple[str, str]:
    """Write a CLIP BPE vocabulary of ``vocab_size`` ids (``vocab.json``,
    ``merges.txt``) and return the two paths: a stand-in for OpenCLIP's
    ``bpe_simple_vocab_16e6`` at its real size, built without a download.

    As in real CLIP: the 256 byte symbols and their ``</w>`` forms first,
    then one id per merge, ``<|startoftext|>`` at ``vocab_size − 2`` and
    ``<|endoftext|>`` at ``vocab_size − 1`` (the text tower pools at the
    largest id of a row). The merges build each word of ``texts`` left to
    right (the merges of other words may still split it; every piece is in
    the vocabulary either way); filler entries pad the ids between."""
    from eeg_image_decode_tpu_torch.data.tokenizers import (
        _CLIP_PAT,
        _whitespace_clean,
        bytes_to_unicode,
    )

    byte_encoder = bytes_to_unicode()
    chars = list(byte_encoder.values())
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges: list[tuple[str, str]] = []
    for text in texts:
        for word in _CLIP_PAT.findall(_whitespace_clean(text).lower()):
            word = "".join(byte_encoder[b] for b in word.encode("utf-8"))
            symbols = list(word[:-1]) + [word[-1] + "</w>"]
            cur = symbols[0]
            for sym in symbols[1:]:
                if cur + sym not in vocab:
                    merges.append((cur, sym))
                    vocab[cur + sym] = len(vocab)
                cur += sym
    if len(vocab) + 2 > vocab_size:
        raise ValueError(f"the texts need {len(vocab) + 2} ids, more than "
                         f"vocab_size={vocab_size}")
    for i in range(vocab_size - 2 - len(vocab)):
        vocab[f"<filler_{i}>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(directory, exist_ok=True)
    vocab_file = os.path.join(directory, "vocab.json")
    merges_file = os.path.join(directory, "merges.txt")
    with open(vocab_file, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_file, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return vocab_file, merges_file


def write_synthetic_wordpiece_vocab(directory: str, texts=(), *,
                                    vocab_size: int = 30522, pad_id: int = 0,
                                    cls_id: int = 101, sep_id: int = 102
                                    ) -> str:
    """Write a WordPiece ``vocab.txt`` of ``vocab_size`` lines and return
    its path: a stand-in for BERT's uncased vocabulary (GIT's) at its real
    size, built without a download. ``[PAD]``, ``[CLS]`` and ``[SEP]`` sit
    at the ids the GIT config decodes with (BERT's 0, 101, 102 by default),
    ``[UNK]`` and ``[MASK]`` at the first free ids. Then the lowercased
    words of ``texts``: every other one whole, the rest only as a 3-letter
    head and a ``##`` tail, so that tokenizing them splits words; filler
    pieces (``tok{i}`` and ``##{i}`` in turn) pad the ids between."""
    from eeg_image_decode_tpu_torch.data.tokenizers import WordPieceTokenizer

    special = {pad_id: "[PAD]", cls_id: "[CLS]", sep_id: "[SEP]"}
    if len(special) != 3 or max(special) >= vocab_size:
        raise ValueError(f"pad, cls and sep ids must differ and lie below "
                         f"vocab_size={vocab_size}: {sorted(special)}")
    words: list[str] = []
    basic = WordPieceTokenizer(["[CLS]", "[SEP]"])._basic_tokenize
    for i, w in enumerate(dict.fromkeys(
            t for text in texts for t in basic(text))):
        words += [w] if i % 2 == 0 or len(w) < 5 else [w[:3], "##" + w[3:]]
    pieces = iter(["[UNK]", "[MASK]", *dict.fromkeys(words)])
    lines = []
    for i in range(vocab_size):
        tok = special.get(i) or next(pieces, None)
        lines.append(tok or (f"tok{i}" if i % 2 else f"##{i}"))
    if next(pieces, None) is not None:
        raise ValueError(f"the texts need more than vocab_size={vocab_size} "
                         "ids")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path
