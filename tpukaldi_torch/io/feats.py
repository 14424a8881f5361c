"""Host-side feature ops: splice, CMVN, deltas — native replacements for the
Kaldi binaries the reference shells out to (`apply-cmvn`, `add-deltas`;
SURVEY.md §2.3), plus the reference's own per-chunk normalization and
context-window semantics (data_io.py:228-272).

All functions are pure numpy (the host data plane), with the native C++
ops of `..native` where they build.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def splice(feats: np.ndarray, left: int, right: int) -> np.ndarray:
    """Context-window splice over a frame axis, reference-exact.

    Matches data_io.py:228-241: each lag column is a circular np.roll of the
    whole (possibly multi-utterance) block, then `left` head rows and `right`
    tail rows are dropped.  Column order is [-left .. +right] lags.

    Uses the native C++ op when available (one pass, no per-lag full-matrix
    copies); numpy fallback otherwise.
    """
    if left == 0 and right == 0:
        return feats
    from .. import native

    fast = native.splice(feats, left, right)
    if fast is not None:
        return fast.astype(feats.dtype, copy=False)
    n, d = feats.shape
    out = np.empty((n, d * (left + right + 1)), dtype=feats.dtype)
    for idx, lag in enumerate(range(-left, right + 1)):
        out[:, idx * d : (idx + 1) * d] = np.roll(feats, -lag, axis=0)
    return out[left : n - right]


def chunk_cmvn(feats: np.ndarray, inplace: bool = False) -> np.ndarray:
    """Per-chunk mean/std normalization over axis 0 (data_io.py:263).
    Native single-pass (double accumulators) when available.
    `inplace=True` may normalize the caller's buffer without copying —
    only pass it for a buffer nothing else references."""
    from .. import native

    fast = native.chunk_cmvn(feats, inplace=inplace)
    if fast is not None:
        return fast
    if inplace and isinstance(feats, np.ndarray) and feats.dtype.kind == "f":
        mean = np.mean(feats, axis=0)
        std = np.std(feats, axis=0)
        feats -= mean
        feats /= std
        return feats
    return (feats - np.mean(feats, axis=0)) / np.std(feats, axis=0)


def read_cmvn_stats(cmvn_ark: str) -> Dict[str, np.ndarray]:
    """Read a Kaldi cmvn stats ark: per speaker a 2 x (dim+1) matrix
    (row 0 = per-dim sums with frame count in the last cell, row 1 = sums of
    squares)."""
    from .kaldi_io import read_mat_ark

    return {k: m for k, m in read_mat_ark(cmvn_ark)}


def apply_cmvn(
    feats: np.ndarray, stats: np.ndarray, norm_vars: bool = False
) -> np.ndarray:
    """Speaker-level CMVN from precomputed stats (native `apply-cmvn`).

    Same arithmetic as the Kaldi binary invoked via cfg `fea_opts`
    (e.g. cfg/TIMIT_baselines/TIMIT_MLP_mfcc_basic.cfg fea_opts line).
    """
    from .. import native

    fast = native.apply_cmvn(feats, stats, norm_vars)
    if fast is not None:
        return fast.astype(feats.dtype)
    dim = feats.shape[1]
    count = stats[0, dim]
    mean = stats[0, :dim] / count
    out = feats - mean
    if norm_vars:
        var = stats[1, :dim] / count - mean**2
        out = out / np.sqrt(np.maximum(var, 1e-20))
    return out.astype(feats.dtype)


def compute_cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Accumulate Kaldi-layout cmvn stats for one utterance/speaker."""
    n, dim = feats.shape
    stats = np.zeros((2, dim + 1), dtype=np.float64)
    stats[0, :dim] = feats.sum(axis=0)
    stats[0, dim] = n
    stats[1, :dim] = (feats.astype(np.float64) ** 2).sum(axis=0)
    return stats


def _delta_scales(order: int, window: int):
    """Kaldi DeltaFeatures filter coefficients (least-squares slope filters,
    composed per order)."""
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return scales


def add_deltas(feats: np.ndarray, order: int = 2, window: int = 2) -> np.ndarray:
    """Append delta features, numerically matching Kaldi `add-deltas`
    (edge frames clamped, default --delta-order=2 --delta-window=2)."""
    n = feats.shape[0]
    scales = _delta_scales(order, window)
    from .. import native

    fast = native.add_deltas(feats, scales, order)
    if fast is not None:
        return fast.astype(feats.dtype)
    blocks = []
    for coeffs in scales:
        offset = (len(coeffs) - 1) // 2
        acc = np.zeros_like(feats, dtype=np.float64)
        for j, c in enumerate(coeffs):
            if c == 0.0:
                continue
            lag = j - offset
            idx = np.clip(np.arange(n) + lag, 0, n - 1)
            acc += c * feats[idx]
        blocks.append(acc)
    return np.concatenate(blocks, axis=1).astype(feats.dtype)


def load_counts(class_counts_file: str) -> np.ndarray:
    """Read an `analyze-counts` output file: `[ c0 c1 ... ]` on one line
    (reference: data_io.py:277-281)."""
    with open(class_counts_file) as f:
        row = next(f).strip().strip("[]").strip()
    return np.array([float(v) for v in row.split()], dtype=np.float32)


def save_counts(counts: np.ndarray, path: str) -> None:
    with open(path, "w") as f:
        f.write("[ " + " ".join(str(float(c)) for c in counts) + " ]\n")
