"""THINGS-MEG preprocessing (copy of ``eeg_image_decode_tpu/preprocess/meg.py``):
the array-level pipeline of ``MEG-preprocessing/pre_possess.ipynb`` (cells
2-36), decoupled from MNE. Host numpy only: it makes no device call.

The notebook reads ``*-epo.fif`` epochs via MNE, crops to [0, 1.0] s, drops
the catch event (999999), identifies the 200 zero-shot test concepts (the
ones with 12 repetitions), removes their overlap from train, and reshapes to

    train: (1654, 12, 1, C, T)   test: (200, 1, 12, C, T)

then pickles dicts per subject. MNE is not a dependency, so this module
takes the already-epoched arrays (epochs × C × T plus event ids) —
obtainable from any .fif reader — and reproduces the sorting/reshaping/save
logic exactly.
"""

from __future__ import annotations

import numpy as np

CATCH_EVENT = 999999


def crop_time_window(
    epochs: np.ndarray, times: np.ndarray, tmin: float = 0.0, tmax: float = 1.0
) -> tuple[np.ndarray, np.ndarray]:
    mask = (times >= tmin) & (times <= tmax)
    return epochs[..., mask], times[mask]


def split_meg_concepts(
    epochs: np.ndarray,
    event_ids: np.ndarray,
    *,
    test_reps: int = 12,
    train_reps: int = 12,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort epochs by concept; concepts seen ``test_reps`` times are the
    zero-shot test set (cells 24-30), the rest are training concepts.

    Returns (train (n_train_cls, reps, C, T), test (n_test_cls, reps, C, T),
    train_concept_ids, test_concept_ids).
    """
    keep = event_ids != CATCH_EVENT
    epochs, event_ids = epochs[keep], event_ids[keep]
    concepts, counts = np.unique(event_ids, return_counts=True)

    test_concepts = concepts[counts == test_reps]
    # the THINGS-MEG test set is exactly 200 concepts; when more match (e.g.
    # synthetic data), keep the first 200 like the notebook's fixed list
    test_concepts = test_concepts[:200]
    train_concepts = np.setdiff1d(concepts, test_concepts)

    def gather(cs, reps):
        out = []
        for c in cs:
            idx = np.nonzero(event_ids == c)[0][:reps]
            out.append(epochs[idx])
        return np.stack(out) if out else np.zeros((0,))

    return (
        gather(train_concepts, train_reps),
        gather(test_concepts, test_reps),
        train_concepts,
        test_concepts,
    )


def split_meg_images(
    epochs: np.ndarray,
    event_ids: np.ndarray,
    image_concepts: np.ndarray,
    *,
    test_reps: int = 12,
    imgs_per_concept: int = 12,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The notebook's REAL image-level semantics (cells 6-27): event ids are
    THINGS *image* indices; zero-shot test images are those repeated exactly
    ``test_reps`` times (``identify_zs_event_ids``); images map to concepts
    via ``image_concepts`` (the 1-indexed ``image_concept_index.csv``
    column); training epochs whose concept overlaps a test concept are
    dropped (cell 27's ``keep_epochs_mask``); the remaining train epochs
    group ``imgs_per_concept`` images per concept (``reshape_meg_data(…,
    num_imgs=12, repetitions=1)``), the test epochs group ``test_reps``
    repetitions per image.

    Returns (train (n_cls, imgs, C, T), test (n_test, reps, C, T),
    train_concept_ids, test_concept_ids). Concepts with a ragged image count
    (≠ ``imgs_per_concept``, possible in partial/synthetic data) are dropped.
    """
    event_ids = np.asarray(event_ids)
    keep = event_ids != CATCH_EVENT
    epochs, event_ids = epochs[keep], event_ids[keep]
    image_concepts = np.asarray(image_concepts)

    ids, counts = np.unique(event_ids, return_counts=True)
    zs_ids = ids[counts == test_reps]
    test_concepts = np.unique(image_concepts[zs_ids - 1])

    is_test = np.isin(event_ids, zs_ids)
    tr_epochs, tr_ids = epochs[~is_test], event_ids[~is_test]
    tr_concepts = image_concepts[tr_ids - 1]
    keep_tr = ~np.isin(tr_concepts, test_concepts)
    tr_epochs, tr_ids, tr_concepts = (
        tr_epochs[keep_tr], tr_ids[keep_tr], tr_concepts[keep_tr]
    )
    order = np.lexsort((tr_ids, tr_concepts))
    tr_epochs, tr_concepts = tr_epochs[order], tr_concepts[order]
    train_concepts, tr_counts = np.unique(tr_concepts, return_counts=True)
    full = tr_counts == imgs_per_concept
    sel = np.isin(tr_concepts, train_concepts[full])
    n_full = int(full.sum())
    train = tr_epochs[sel].reshape(
        (n_full, imgs_per_concept) + epochs.shape[1:]
    )

    te_epochs, te_ids = epochs[is_test], event_ids[is_test]
    order = np.argsort(te_ids, kind="stable")
    test = te_epochs[order].reshape(
        (len(zs_ids), test_reps) + epochs.shape[1:]
    )
    return train, test, train_concepts[full], test_concepts


def to_reference_layout(
    train: np.ndarray, test: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Insert the singleton axes of the notebook's saved layout (cell 36):
    train (n, reps, C, T) → (n, reps, 1, C, T); test → (n, 1, reps, C, T)."""
    return train[:, :, None], test[:, None]


def save_meg(path: str, train: np.ndarray, test: np.ndarray, ch_names, times):
    import os
    import pickle

    os.makedirs(path, exist_ok=True)
    for name, arr in (("train", train), ("test", test)):
        with open(os.path.join(path, f"preprocessed_meg_{name}.npy"), "wb") as f:
            pickle.dump(
                {
                    "meg_data": arr,
                    "ch_names": list(ch_names),
                    "times": np.asarray(times),
                },
                f,
                protocol=4,
            )
