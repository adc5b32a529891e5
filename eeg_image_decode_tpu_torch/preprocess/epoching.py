"""Epoching: raw THINGS-EEG sessions → sorted condition × rep epoch tensors
(counterpart of ``eeg_image_decode_tpu/preprocess/epoching.py``; ref
``EEG-preprocessing/preprocessing_utils.py:1-113``, without MNE).

Channel selection in the canonical 63-channel order, stim-channel events,
target-trial rejection (event 99999), epochs over [−0.2, 1.0] s with the
pre-stimulus baseline subtracted, polyphase resampling to 250 Hz, a seeded
per-condition rep selection (at most 20 test / 2 training reps), and the
drop of the first 50 samples (ref ``:108``).

The bookkeeping runs in numpy on the host, exactly as in the JAX package:
events, rejection, the per-condition ``RandomState(seed)`` selection, the
merges' permutations and the pickle. The array work runs in float64 on the
entry's device, one chunk of the selected epochs at a time: the gather
``data[:, onsets + win]``, the baseline and the resample, which applies
scipy ``resample_poly``'s FIR taps (designed on the host) as a strided
convolution with its zero padding and output trimming.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

from eeg_image_decode_tpu_torch.utils.device import resolve_device

CHANNEL_ORDER = [
    "Fp1", "Fp2", "AF7", "AF3", "AFz", "AF4", "AF8", "F7", "F5", "F3",
    "F1", "F2", "F4", "F6", "F8", "FT9", "FT7", "FC5", "FC3", "FC1",
    "FCz", "FC2", "FC4", "FC6", "FT8", "FT10", "T7", "C5", "C3", "C1",
    "Cz", "C2", "C4", "C6", "T8", "TP9", "TP7", "CP5", "CP3", "CP1",
    "CPz", "CP2", "CP4", "CP6", "TP8", "TP10", "P7", "P5", "P3", "P1",
    "Pz", "P2", "P4", "P6", "P8", "PO7", "PO3", "POz", "PO4", "PO8",
    "O1", "Oz", "O2",
]
TARGET_EVENT = 99999
#: selected epochs per device chunk: 1024 × 63 × 1201 float64 is 620 MB
EPOCH_CHUNK = 1024


def find_events(stim: np.ndarray) -> np.ndarray:
    """0→value onsets on the stim channel → (n_events, 2): (sample, value)."""
    stim = np.asarray(stim)
    prev = np.concatenate([[0], stim[:-1]])
    onsets = np.nonzero((prev == 0) & (stim != 0))[0]
    return np.stack([onsets, stim[onsets].astype(np.int64)], axis=1)


def resample_taps(up: int, down: int) -> tuple[np.ndarray, int]:
    """scipy ``resample_poly``'s filter for ``up``/``down`` (already reduced
    by their gcd): (float64 taps, scaled by ``up`` and zero-padded in front
    as scipy pads them; the output samples to drop at the start)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    h = h * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return np.concatenate([np.zeros(n_pre_pad), h]), n_pre_remove


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Polyphase resampling of float64 ``x`` along its last axis, on its
    device: scipy's ``resample_poly(x, up, down, axis=-1)`` (Kaiser(5.0)
    window, zero padding). The upsampled signal is convolved with the taps
    at stride ``down`` (``F.conv1d`` of the flipped taps) and trimmed to
    scipy's ``ceil(n·up/down)`` samples."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x.clone()
    taps, n_pre_remove = resample_taps(up, down)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    rows = x.reshape(-1, 1, n_in)
    if up > 1:  # zeros between the samples: (n_in − 1)·up + 1 long
        z = rows.new_zeros((rows.shape[0], 1, (n_in - 1) * up + 1))
        z[..., ::up] = rows
        rows = z
    h = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype, device=x.device)
    # y[k] = Σ_j h[j]·x_up[k·down − j]: a full convolution (len(h) − 1
    # zeros on both sides) sampled at stride `down`, from output
    # n_pre_remove on; scipy's post-padding only ever adds zero taps
    start = n_pre_remove * down
    need = start + (n_out - 1) * down + len(taps)
    padded = torch.nn.functional.pad(
        rows, (len(taps) - 1, max(0, need - rows.shape[-1] - len(taps) + 1)))
    y = torch.nn.functional.conv1d(padded[..., start:need], h.view(1, 1, -1),
                                   stride=down)
    return y.reshape(*x.shape[:-1], n_out)


def select_epochs(values: np.ndarray, max_rep: int, seed: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The seeded per-condition rep selection (ref ``:89-106``): (sorted
    conditions, (conditions, max_rep) event indices), drawn from one
    ``RandomState(seed)`` in condition order, as the JAX package draws it.
    Its numpy assignment semantics hold too: a condition with one event
    fills every rep with it, and one with more than one but fewer than
    ``max_rep`` raises ``ValueError``."""
    conditions = np.unique(values)
    rng = np.random.RandomState(seed)
    picks = np.empty((len(conditions), max_rep), np.int64)
    for i, cond in enumerate(conditions):
        cond_idx = np.nonzero(values == cond)[0]
        pick = rng.permutation(len(cond_idx))[:max_rep]
        picks[i] = cond_idx[pick]
    return conditions, picks


def epoch_session(
    raw,
    ch_names: list[str],
    sfreq: float,
    stim: np.ndarray,
    *,
    target_sfreq: float = 250.0,
    tmin: float = -0.2,
    tmax: float = 1.0,
    max_rep: int = 2,
    seed: int = 20200220,
    drop_initial: int = 50,
    device=None,
    chunk: int = EPOCH_CHUNK,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """One session → (epochs (conditions, max_rep, 63, T') float32 on
    ``device``, conditions, times).

    ``raw``: (n_channels, n_samples) EEG, numpy or a tensor; ``stim``:
    (n_samples,) event channel. ``device``: where the array work runs (the
    CUDA card by default, raising without one; ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    # channel selection in canonical order (ref :70)
    idx = [ch_names.index(ch) for ch in CHANNEL_ORDER if ch in ch_names]
    data = torch.as_tensor(raw)[idx].to(dev, torch.float64)

    events = find_events(stim)
    events = events[events[:, 1] != TARGET_EVENT]  # ref :72-73

    n_pre = int(round(-tmin * sfreq))
    n_post = int(round(tmax * sfreq))
    onsets, values = events[:, 0], events[:, 1]
    keep = (onsets - n_pre >= 0) & (onsets + n_post < data.shape[1])
    onsets, values = onsets[keep], values[keep]

    up, down = 1, 1
    if target_sfreq < sfreq:
        up, down = int(target_sfreq), int(sfreq)
        g = math.gcd(up, down)
        up, down = up // g, down // g
    n_win = n_pre + n_post + 1
    t_len = -(-n_win * up // down)
    times = np.linspace(tmin, tmax, t_len)

    # sort by condition, seeded rep subsample (ref :89-106); each epoch is
    # computed on its own, so only the selected ones are
    conditions, picks = select_epochs(values, max_rep, seed)
    flat = picks.reshape(-1)
    out = torch.empty((len(flat), data.shape[0], t_len - drop_initial),
                      dtype=torch.float32, device=dev)
    win = torch.arange(-n_pre, n_post + 1, device=dev)
    sel = torch.as_tensor(onsets[flat], device=dev)
    for lo in range(0, len(flat), chunk):
        # epoch + baseline-correct over [tmin, 0] (mne baseline=(None, 0))
        at = sel[lo:lo + chunk, None] + win[None, :]        # (n, T)
        ep = data[:, at].permute(1, 0, 2)                   # (n, C, T)
        ep = ep - ep[:, :, :n_pre].mean(dim=2, keepdim=True)
        if up != down:
            ep = resample_poly(ep, up, down)
        out[lo:lo + chunk] = ep[..., drop_initial:]
    return (out.reshape(len(conditions), max_rep, *out.shape[1:]),
            conditions, times)


def merge_sessions_test(whitened: list[np.ndarray], seed: int = 20200220):
    """Concatenate session reps and shuffle them (ref ``save_prepr``
    :231-238)."""
    merged = np.concatenate(whitened, axis=1)
    rng = np.random.RandomState(seed)
    return merged[:, rng.permutation(merged.shape[1])]


def merge_sessions_train(
    whitened: list[np.ndarray],
    conditions: list[np.ndarray],
    seed: int = 20200220,
):
    """Group per-condition reps across sessions (conditions are 1-based ids
    in the reference, ref :272-282), then shuffle the reps."""
    data = np.concatenate(whitened, axis=0)
    cond = np.concatenate(conditions, axis=0)
    uniq = np.unique(cond)
    reps_total = data.shape[1] * int(np.sum(cond == uniq[0]))
    merged = np.zeros(
        (len(uniq), reps_total, data.shape[2], data.shape[3]), data.dtype
    )
    for i, c in enumerate(uniq):
        merged[i] = np.concatenate(list(data[cond == c]), axis=0)
    rng = np.random.RandomState(seed)
    return merged[:, rng.permutation(merged.shape[1])]


def save_preprocessed(path: str, data: np.ndarray, ch_names, times) -> None:
    """Write the reference's pickled-dict format (``:241-258``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "preprocessed_eeg_data": data,
                "ch_names": list(ch_names),
                "times": np.asarray(times),
            },
            f,
            protocol=4,
        )
