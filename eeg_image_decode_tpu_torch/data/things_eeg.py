"""THINGS-EEG dataset ingestion (counterpart of
``eeg_image_decode_tpu/data/things_eeg.py``; ref
``Retrieval/eegdatasets_leaveone.py``, ``eegdatasets_joint_subjects.py``):
one loader with flags, producing flat arrays instead of a torch Dataset.

- train: per subject, (1654 classes × 10 images × 4 reps) epochs flattened
  to (66160, 63, 250) with labels repeat-interleaved ×4 (ref ``:236-258``)
- test: 200 classes × 1 image × 80 reps, averaged over reps by default
  (ref ``:220``), or kept un-averaged
- time-window slice [0, 1.0] s via the stored ``times`` vector
  (ref ``:280-294``)
- per-sample image/text feature indices precomputed on the host: the
  reference's per-item index arithmetic (``:326-375``) becomes two int32
  arrays, so a batch is a pure gather on the card.

The file format is the reference's output
(``preprocessing_utils.py:241-258``): a pickled dict per subject with keys
``preprocessed_eeg_data``, ``ch_names``, ``times``; THINGS-MEG pickles use
``meg`` file names and a ``meg_data`` key.

:class:`EEGRetrievalData` holds numpy arrays, or tensors already on a
device (``data/synthetic.py::make_synthetic_retrieval_data``).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from eeg_image_decode_tpu_torch.data.native_loader import NpyMmap


@dataclass
class EEGRetrievalData:
    """Flat view of one retrieval dataset split (possibly multi-subject)."""

    eeg: np.ndarray  # (N, C, T) float32
    labels: np.ndarray  # (N,) int32 class ids
    subject_ids: np.ndarray  # (N,) int32
    img_idx: np.ndarray  # (N,) int32 index into img_features
    text_idx: np.ndarray  # (N,) int32 index into text_features
    img_features: np.ndarray  # (n_imgs, D) float32
    text_features: np.ndarray  # (n_cls, D) float32
    n_classes: int
    images_per_class: int = 1

    @property
    def n(self) -> int:
        return int(self.eeg.shape[0])

    def class_img_features(self):
        """One image feature per class (the train-time probe's targets)."""
        return self.img_features[:: self.images_per_class]


def extract_subject_id(sub: str) -> int:
    """'sub-08' → 8 (ref ``ATMS_retrieval.py:193-197``)."""
    m = re.search(r"\d+$", sub)
    return int(m.group()) if m else -1


#: open sidecar maps by path, each with the (inode, size, mtime) of the file
#: it maps: one map per file however often it is loaded (a leave-one-out
#: sweep reloads subjects), and a file rewritten since is mapped anew. A map
#: dropped from here stays mapped while an array taken from it lives.
_OPEN_MMAPS: dict[str, tuple[tuple, NpyMmap]] = {}


def _sidecar_map(path: str) -> NpyMmap:
    st = os.stat(path)
    key = (st.st_ino, st.st_size, st.st_mtime_ns)
    hit = _OPEN_MMAPS.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    m = NpyMmap(path)
    _OPEN_MMAPS[path] = (key, m)
    return m


def drop_sidecar_maps(root: str) -> None:
    """Forget the open sidecar maps under ``root`` (before its files are
    deleted, so their disk space is freed once no array still uses them)."""
    root = os.path.join(os.path.abspath(root), "")
    for path in list(_OPEN_MMAPS):
        if os.path.abspath(path).startswith(root):
            del _OPEN_MMAPS[path]


def _load_subject_file(data_path: str, subject: str, train: bool) -> dict:
    name = ("preprocessed_eeg_training.npy" if train
            else "preprocessed_eeg_test.npy")
    path = os.path.join(data_path, subject, name)
    if not os.path.exists(path):
        # THINGS-MEG pickles live under the same per-subject convention with
        # 'meg' names and a 'meg_data' key
        meg = os.path.join(
            data_path, subject,
            "preprocessed_meg_train.npy" if train
            else "preprocessed_meg_test.npy")
        if os.path.exists(meg):
            path = meg

    # Sidecar raw-array cache: the reference pickles a dict into the .npy
    # (preprocessing_utils.py:256-258), which forces a full unpickle copy of
    # ~4.2 GB per subject on every run. The first load writes the EEG tensor
    # as a real .npy next to it; later loads map it through the native
    # reader (data/native_loader.py::NpyMmap) with readahead over the whole
    # file, and page it in lazily.
    cache_data = path + ".raw.npy"
    cache_meta = path + ".meta.npz"
    if (os.path.exists(cache_data) and os.path.exists(cache_meta)
            and os.path.getmtime(cache_data) >= os.path.getmtime(path)):
        try:
            m = _sidecar_map(cache_data)
            m.willneed()
            data = m.array
            with np.load(cache_meta, allow_pickle=True) as meta:
                out = {k: meta[k] for k in meta.files}
            out["ch_names"] = list(out.get("ch_names", np.asarray([])))
            key = str(out.pop("data_key", "preprocessed_eeg_data"))
            out[key] = data
            return out
        except (OSError, ValueError, KeyError):
            # damaged or truncated cache (a killed writer): read the pickle
            # and rewrite the cache below
            _OPEN_MMAPS.pop(cache_data, None)

    # the subject files are the output of this project's preprocessing: a
    # pickled dict inside the .npy
    raw = np.load(path, allow_pickle=True)
    if isinstance(raw, np.ndarray):  # a 0-d object array from np.save(dict)
        raw = raw.item()
    key = ("preprocessed_eeg_data" if "preprocessed_eeg_data" in raw
           else "meg_data")
    try:  # best effort: data directories may be read-only
        # write to a temporary name and rename: a concurrent reader must
        # never pass the mtime check and map a half-written cache
        tmp = cache_data + ".tmp.npy"  # np.save appends .npy otherwise
        np.save(tmp, np.asarray(raw[key]))
        np.savez(cache_meta + ".tmp.npz", times=np.asarray(raw["times"]),
                 ch_names=np.asarray(raw.get("ch_names", []), dtype=object),
                 data_key=key)
        os.replace(cache_meta + ".tmp.npz", cache_meta)
        os.replace(tmp, cache_data)
    except OSError:
        pass
    return raw


def _time_window_mask(times: np.ndarray, window: tuple[float, float],
                      data_t: int) -> np.ndarray:
    # the reference drops the first 50 post-epoch samples before saving but
    # stores the full `times`, then slices times[50:] at load
    # (``eegdatasets_leaveone.py:161``); replicate the skip when the stored
    # grid is longer than the data's time axis
    t = np.asarray(times)
    if t.shape[0] == data_t + 50:
        t = t[50:]
    return (t >= window[0]) & (t <= window[1])


def _window_index(mask: np.ndarray):
    """The time window as an index of the last axis: a slice when the mask
    is one run of samples (a monotone time grid always gives one), which
    takes a view where a boolean index gathers every element (most of a
    full subject's ingest time, ``PERF.md`` §6); the mask otherwise."""
    idx = np.flatnonzero(mask)
    if idx.size and idx[-1] - idx[0] + 1 == idx.size:
        return slice(int(idx[0]), int(idx[-1]) + 1)
    return mask


def load_things_eeg_subject(
    data_path: str,
    subject: str,
    *,
    train: bool,
    time_window: tuple[float, float] = (0.0, 1.0),
    average_test_reps: bool = True,
    classes: list[int] | None = None,
    pictures: list[int] | None = None,
    val_size=None,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Load one subject's epochs → (eeg, labels).

    train: (n_cls*10*4, C, T'), labels repeat-interleaved;
    test averaged: (200, C, T'); un-averaged: (200*80, C, T').

    THINGS-MEG pickles (``meg_data`` key, the 5-D layout: train (n_cls,
    imgs, reps, C, T), test (n_cls, 1, reps, C, T)) load through the same
    interface: the extra axis folds into the EEG layout and the images per
    class come from the stored shape (12) instead of 10.

    Subset options (ref ``eegdatasets_leaveone.py:40,168-216``; analysis
    conveniences that no reference training script passes):

    - ``classes``: keep only the listed class indices (train: every image
      × rep of each class; test: the listed concepts). Labels keep their
      original class ids, like the reference.
    - ``pictures`` (with ``classes``, train only): per ``(class, picture)``
      pair keep that single image's repetitions. The reference computes the
      flat index as ``c * 1 + p`` (``:171``), which puts every condition
      after class 0 in the wrong class; this loader implements the
      documented intent, ``c * images_per_class + p``, as the JAX loader
      does.
    - ``val_size``: accepted and ignored, as in the reference, which stores
      it and never reads it."""
    del val_size  # dead in the reference too (stored at :51, never read)
    raw = _load_subject_file(data_path, subject, train)
    n_img_per_cls = 10
    if "preprocessed_eeg_data" in raw:
        data = np.asarray(raw["preprocessed_eeg_data"], dtype=dtype)
    else:
        data = np.asarray(raw["meg_data"], dtype=dtype)
        if train:
            # (n_cls, imgs, reps, C, T) → (n_cls*imgs, reps, C, T)
            n_img_per_cls = data.shape[1]
            data = data.reshape(data.shape[0] * data.shape[1],
                                *data.shape[2:])
        else:
            data = data[:, 0]  # (n_cls, 1, reps, C, T) → (n_cls, reps, C, T)
    mask = _time_window_mask(raw["times"], time_window, data.shape[-1])
    if mask.shape[0] == data.shape[-1]:
        data = data[..., _window_index(mask)]

    if pictures is not None and (classes is None or not train):
        raise ValueError("pictures requires classes and train=True "
                         "(ref eegdatasets_leaveone.py:168-175)")

    if train:
        # (n_cls*10, reps=4, C, T) stored flat in class-major order
        if classes is not None:
            if pictures is not None:
                if len(pictures) != len(classes):
                    raise ValueError(
                        f"classes ({len(classes)}) and pictures "
                        f"({len(pictures)}) must pair up elementwise")
                conds = np.asarray([c * n_img_per_cls + p
                                    for c, p in zip(classes, pictures)],
                                   np.int64)
                cond_labels = np.asarray(classes, np.int32)
            else:
                conds = np.asarray([c * n_img_per_cls + j for c in classes
                                    for j in range(n_img_per_cls)], np.int64)
                cond_labels = np.repeat(np.asarray(classes, np.int32),
                                        n_img_per_cls)
            data = data[conds]
            n_rep = data.shape[1]
            eeg = data.reshape(data.shape[0] * n_rep, *data.shape[2:])
            return eeg, np.repeat(cond_labels, n_rep)
        n_cond, n_rep = data.shape[0], data.shape[1]
        # the one copy out of the window's view (of a mapped cache, perhaps)
        eeg = np.array(data.reshape(n_cond * n_rep, *data.shape[2:]),
                       order="C")
        labels = np.repeat(np.arange(n_cond // n_img_per_cls, dtype=np.int32),
                           n_img_per_cls * n_rep)
        return eeg, labels
    # test: (200, 80, C, T)
    keep = (np.arange(data.shape[0]) if classes is None
            else np.asarray(sorted(set(classes)), np.int64))
    data = data[keep]
    cls_ids = keep.astype(np.int32)
    if average_test_reps:
        return data.mean(axis=1), cls_ids
    return (data.reshape(-1, *data.shape[2:]),
            np.repeat(cls_ids, data.shape[1]))


def build_retrieval_data(
    data_path: str,
    subjects: list[str],
    *,
    train: bool,
    img_features: np.ndarray,
    text_features: np.ndarray,
    exclude_subject: str | None = None,
    time_window: tuple[float, float] = (0.0, 1.0),
    average_test_reps: bool = True,
    images_per_class: int = 10,
    train_reps: int = 4,
) -> EEGRetrievalData:
    """Multi-subject concatenation with the reference's leave-one semantics:
    train skips ``exclude_subject`` (``eegdatasets_leaveone.py:153-154``);
    test keeps only it (or all when None)."""
    eeg_list, label_list, sid_list = [], [], []
    for sub in subjects:
        if train and sub == exclude_subject:
            continue
        if (not train and exclude_subject is not None
                and sub != exclude_subject):
            continue
        eeg, labels = load_things_eeg_subject(
            data_path, sub, train=train, time_window=time_window,
            average_test_reps=average_test_reps)
        eeg_list.append(eeg)
        label_list.append(labels)
        sid_list.append(np.full(eeg.shape[0], extract_subject_id(sub),
                                dtype=np.int32))
    # every subject's array is its own copy already: one is used as it is
    eeg = (eeg_list[0] if len(eeg_list) == 1
           else np.concatenate(eeg_list, axis=0))
    labels = np.concatenate(label_list, axis=0)
    sids = np.concatenate(sid_list, axis=0)

    block = labels.shape[0] // len(eeg_list)
    local = np.arange(labels.shape[0]) % block
    if train:
        # per-subject block layout: index i within a subject block maps to
        # text_idx = (i % block) // (10*4), img_idx = (i % block) // 4
        # (ref ``eegdatasets_leaveone.py:326-360``)
        text_idx = (local // (images_per_class * train_reps)).astype(np.int32)
        img_idx = (local // train_reps).astype(np.int32)
        ipc = images_per_class
        # text_idx must reproduce the loader's class labels exactly; a
        # mismatch means images_per_class/train_reps disagree with the
        # stored layout (e.g. MEG's 12×1 loaded with the EEG default 10×4)
        # and every EEG row would silently pair with the wrong CLIP feature
        if not np.array_equal(text_idx, labels.astype(np.int32)):
            raise ValueError(
                f"images_per_class={images_per_class} × train_reps="
                f"{train_reps} does not match the stored layout "
                f"({block} rows / {int(labels[:block].max()) + 1} classes "
                "per subject) — for THINGS-MEG pass images_per_class=12, "
                "train_reps=1 (CLI: --images-per-class 12 --train-reps 1)")
    else:
        n_cls_sub = int(labels[:block].max()) + 1
        # per-concept repetition count from the data itself (EEG 80, MEG 12)
        reps = 1 if average_test_reps else max(1, block // n_cls_sub)
        text_idx = (local // reps).astype(np.int32)
        img_idx = text_idx.copy()
        ipc = 1

    return EEGRetrievalData(
        eeg=eeg,
        labels=labels.astype(np.int32),
        subject_ids=sids,
        img_idx=img_idx,
        text_idx=text_idx,
        img_features=np.asarray(img_features, np.float32),
        text_features=np.asarray(text_features, np.float32),
        n_classes=int(labels.max()) + 1,
        images_per_class=ipc,
    )


def list_image_classes(img_directory: str) -> tuple[list[str], list[str]]:
    """Sorted class folders → (folder names, text prompts). Prompt template
    'This picture is {description}' (ref ``eegdatasets_leaveone.py:96-105``).
    Folders without an underscore get no prompt, exactly like the reference,
    which then misaligns prompts with classes; prefer
    :func:`things_images_and_prompts`."""
    dirs = sorted(d for d in os.listdir(img_directory)
                  if os.path.isdir(os.path.join(img_directory, d)))
    prompts = []
    for d in dirs:
        if "_" not in d:
            continue
        desc = d[d.index("_") + 1:]
        prompts.append(f"This picture is {desc}")
    return dirs, prompts


def things_images_and_prompts(root: str) -> tuple[list[str], list[str]]:
    """THINGS ``images_set`` layout (``<root>/<NNNNN_concept>/<img>.jpg``) →
    (sorted image paths, one prompt per class dir), the aligned pair the
    CLIP feature cache needs. Same template as :func:`list_image_classes`,
    but a dir without an underscore keeps its whole name as the concept, so
    prompts always stay class-aligned."""
    dirs = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))
    if not dirs:
        raise ValueError(f"no class directories under {root}")
    exts = (".png", ".jpg", ".jpeg")
    paths, prompts = [], []
    for d in dirs:
        desc = d.split("_", 1)[1] if "_" in d else d
        prompts.append(f"This picture is {desc}")
        sub = os.path.join(root, d)
        paths.extend(os.path.join(sub, f) for f in sorted(os.listdir(sub))
                     if f.lower().endswith(exts))
    if not paths:
        raise ValueError(f"no images under the class dirs of {root}")
    return paths, prompts
