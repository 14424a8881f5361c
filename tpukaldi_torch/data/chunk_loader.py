"""Chunk loading: ark features + alignment labels -> one contiguous chunk.

Re-implements the semantics of the reference's host data plane
(data_io.py:16-281 `load_dataset`/`load_chunk`, data_io.py:522-647
`read_lab_fea`) as a typed pipeline:

  read feats (native scp/ark + fea_opts pipeline)
  -> sentence split at max_seq_length with the min-tail rule (len/4)
  -> sort by length, concatenate, end-index arrays
  -> context-window splice (roll semantics), per-chunk CMVN
  -> label min-subtraction + cw trim
  -> multi-stream column stacking with cw_max compensation
  -> optional frame shuffle (non-sequential models)

Features and labels stay in separate arrays (float32 / int32) instead of the
reference's single float matrix with label columns; the layout dicts map
stream names to column ranges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config.cfg import DatasetSpec, FeatureSpec, LabelSpec
from ..io import feats as F
from ..io import kaldi_io as kio
from ..io.pipeline import apply_pipeline, parse_pipeline
from .labels import read_label_stream


@dataclass
class ChunkData:
    """One loaded chunk, ready for batching.

    `lab_end_index` differs from `end_index` only on the raw-waveform path
    where features are samples and labels are 10 ms frames (the reference's
    refac01 6-tuple max_seq_length, data_io.py:167-201,284-309)."""

    names: List[str]  # per (possibly split) sentence
    feats: np.ndarray  # (N_frames, D) float32, all feature streams stacked
    labs: np.ndarray  # (N_lab_frames, L) int32, one column per label stream
    end_index: np.ndarray  # cumulative sentence end rows (features)
    fea_layout: Dict[str, Tuple[int, int]]  # stream -> column range
    lab_layout: Dict[str, int]  # stream -> label column
    shuffled: bool = False
    lab_end_index: Optional[np.ndarray] = None  # defaults to end_index
    window_shift: int = 1  # raw-wave: samples per label frame step
    window_size: int = 1  # raw-wave: samples per label frame window

    def __post_init__(self):
        if self.lab_end_index is None:
            self.lab_end_index = self.end_index

    @property
    def rates_differ(self) -> bool:
        # derived from the chunk window config, NOT from comparing label
        # indices: in production (fea_only) mode labels are absent so
        # lab_end_index == end_index even on the raw-waveform path, and the
        # sample->frame posterior length conversion plus the forward
        # batch-size=1 guard must still apply
        return self.window_size > 1 or self.window_shift > 1

    @property
    def n_frames(self) -> int:
        return self.feats.shape[0]

    @property
    def n_sentences(self) -> int:
        return len(self.names)

    @property
    def sentence_lengths(self) -> np.ndarray:
        starts = np.concatenate([[0], self.end_index[:-1]])
        return self.end_index - starts

    @property
    def lab_sentence_lengths(self) -> np.ndarray:
        starts = np.concatenate([[0], self.lab_end_index[:-1]])
        return self.lab_end_index - starts

    def fea_dim(self, name: str) -> int:
        beg, end = self.fea_layout[name]
        return end - beg


def _chunk_config(max_seq_length) -> Dict[str, int]:
    """Normalize int or 6-int-list max_seq_length to the chunk config
    (reference data_io.py:117-130,294-309).  List order:
    size_fea, step_fea, size_lab, step_lab, window_shift, window_size."""
    if isinstance(max_seq_length, (list, tuple)):
        sf, stf, sl, stl, shift, window = [int(v) for v in max_seq_length]
        # a zero/negative step would make _split_sentence's window never
        # advance (unbounded loop); sizes of -1 mean "no splitting"
        # (forward mode) and skip the split path entirely
        if sf > 0 and (stf <= 0 or stl <= 0):
            raise ValueError(
                f"max_seq_length steps must be positive when splitting: "
                f"step_fea={stf}, step_lab={stl} (6-tuple {max_seq_length})"
            )
        if shift <= 0 or window <= 0:
            raise ValueError(
                f"max_seq_length window_shift/window_size must be positive "
                f"(6-tuple {max_seq_length})"
            )
        return {
            "size_fea": sf, "step_fea": stf, "size_lab": sl, "step_lab": stl,
            "window_shift": shift, "window_size": window,
        }
    m = int(max_seq_length)
    return {
        "size_fea": m, "step_fea": m, "size_lab": m, "step_lab": m,
        "window_shift": 1, "window_size": 1,
    }


def _split_sentence(
    fea: np.ndarray, lab: Optional[np.ndarray], cc: Dict[str, int]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split one utterance into <=size_fea chunks with the reference's
    min-tail rule (the final piece absorbs up to size + size/4 frames,
    data_io.py:68-115); labels chunked at their own size/step."""
    n = len(fea)
    size_fea, step_fea = cc["size_fea"], cc["step_fea"]
    size_lab, step_lab = cc["size_lab"], cc["step_lab"]
    if lab is None:
        lab = np.zeros((0,), dtype=np.int64)
    if size_fea <= 0 or n <= size_fea:
        return [(fea, lab)]
    out = []
    threshold = size_fea + size_fea / 4
    i = 0
    while True:
        start = i * step_fea
        lab_start = i * step_lab
        if n - start > threshold:
            out.append(
                (fea[start : start + size_fea],
                 lab[lab_start : lab_start + size_lab])
            )
        else:
            out.append((fea[start:], lab[lab_start:]))
            break
        i += 1
    return out


def load_dataset_stream(
    fea: FeatureSpec,
    lab: Optional[LabelSpec],
    max_seq_length,
    fea_only: bool = False,
):
    """Read one (feature, label) stream pair and produce concatenated,
    length-sorted sentence chunks (reference load_dataset, data_io.py:16-210).

    `max_seq_length` is an int, or the raw-wave 6-int list
    (size_fea, step_fea, size_lab, step_lab, window_shift, window_size)
    when features and labels run at different time rates.

    Returns (names, fea_conc, lab_conc, end_index, lab_end_index).
    """
    cc = _chunk_config(max_seq_length)
    stages = parse_pipeline(fea.opts) if fea.opts else []
    # wav-vs-feature sniffing by RIFF header (data_io.py:19-28)
    first_rx = next(iter(kio.read_scp_entries(fea.lst)), None)
    if first_rx is None:
        raise ValueError(f"empty feature list {fea.lst!r}")
    is_wav = False
    path = first_rx[1].rpartition(":")[0] or first_rx[1]
    with open(path, "rb") as f:
        # the RIFF magic sits right after the first utterance key in a wav
        # ark, so the window must cover the longest plausible key (a fixed
        # 64 bytes truncated long TIMIT-style keys and misrouted the ark
        # into the matrix parser)
        head = f.read(max(64, len(first_rx[0]) + 16))
        is_wav = b"RIFF" in head

    feats: Dict[str, np.ndarray] = {}
    for key, rx in kio.read_scp_entries(fea.lst):
        mat = kio.read_vec_flt(rx)[:, None] if is_wav else kio.read_mat(rx)
        feats[key] = apply_pipeline(stages, key, mat) if stages else mat

    labels: Dict[str, np.ndarray] = {}
    if not fea_only and lab is not None:
        labels = read_label_stream(lab.folder, lab.opts)
        # keep only utterances with both fea and lab (data_io.py:50-55)
        common = [k for k in feats if k in labels]
        if not common:
            raise ValueError(
                f"no utterances shared between features ({fea.lst!r}) and "
                f"labels ({lab.folder!r}) — check the lab_folder alignment "
                f"directory for this dataset"
            )
        feats = {k: feats[k] for k in common}
        labels = {k: labels[k] for k in common}

    rates_differ = cc["window_size"] > 1 or cc["window_shift"] > 1
    if rates_differ and labels:
        # feature samples vs label frames: pad/trim features to
        # (n_lab - 1) * shift + window samples (data_io.py:167-201)
        for k in list(feats):
            n_fea = feats[k].shape[0]
            want = (labels[k].shape[0] - 1) * cc["window_shift"] + cc["window_size"]
            if abs(n_fea - want) > cc["window_shift"]:
                raise ValueError(
                    f"utterance {k!r}: {n_fea} feature rows vs {want} "
                    f"expected from {labels[k].shape[0]} labels"
                )
            if n_fea > want:
                feats[k] = feats[k][:want]
            elif n_fea < want:
                pad = np.zeros((want - n_fea,) + feats[k].shape[1:],
                               dtype=feats[k].dtype)
                feats[k] = np.concatenate([feats[k], pad])

    names: List[str] = []
    fea_parts: List[np.ndarray] = []
    lab_parts: List[np.ndarray] = []
    # sort keys alphabetically then (stable) by length — data_io.py:135
    ordered = sorted(sorted(feats.keys()), key=lambda k: len(feats[k]))
    for key in ordered:
        lab_arr = labels.get(key) if labels else None
        pieces = _split_sentence(feats[key], lab_arr, cc)
        for j, (fp, lp) in enumerate(pieces):
            names.append(f"{key}_split{j}" if len(pieces) > 1 else key)
            fea_parts.append(fp)
            if lab_arr is None:
                lp = np.zeros((fp.shape[0],), dtype=np.int64)
            lab_parts.append(lp)

    # final sort of the split pieces by length (data_io.py:146-150)
    order = np.argsort([p.shape[0] for p in fea_parts], kind="stable")
    names = [names[i] for i in order]
    fea_parts = [fea_parts[i] for i in order]
    lab_parts = [lab_parts[i] for i in order]

    end_index = np.cumsum([p.shape[0] for p in fea_parts])
    lab_end_index = np.cumsum([p.shape[0] for p in lab_parts])
    fea_conc = np.concatenate(fea_parts) if fea_parts else np.zeros((0, 1))
    lab_conc = np.concatenate(lab_parts) if lab_parts else np.zeros((0,))
    return names, fea_conc, lab_conc, end_index, lab_end_index


def load_chunk_stream(
    fea: FeatureSpec,
    lab: Optional[LabelSpec],
    max_seq_length,
    fea_only: bool = False,
):
    """load_dataset + splice + per-chunk CMVN + label trim
    (reference load_chunk, data_io.py:244-274)."""
    names, fea_conc, lab_conc, end_index, lab_end_index = load_dataset_stream(
        fea, lab, max_seq_length, fea_only
    )
    rates_differ = not np.array_equal(end_index, lab_end_index)
    left, right = fea.cw_left, fea.cw_right
    if left != 0 or right != 0:
        if rates_differ:
            raise ValueError(
                "context windows are unsupported when feature/label time "
                "rates differ (raw-wave path uses cw 0/0)"
            )
        fea_conc = F.splice(fea_conc, left, right)
    end_index = end_index - left
    end_index[-1] = end_index[-1] - right
    # inplace: fea_conc was freshly built by concatenate/splice above, so
    # normalizing the owned buffer avoids a full-chunk copy (expensive at
    # Librispeech scale and on memory-throttled hosts)
    fea_conc = F.chunk_cmvn(fea_conc, inplace=True)
    if not fea_only and lab_conc.size:
        lab_conc = lab_conc - lab_conc.min()
    if not rates_differ:
        lab_conc = lab_conc[left : len(lab_conc) - right if right > 0 else None]
        lab_end_index = end_index
    return (
        names,
        np.asarray(fea_conc, dtype=np.float32),
        np.asarray(lab_conc, dtype=np.int64),
        end_index,
        lab_end_index,
    )


def load_chunk(
    dataset: DatasetSpec,
    fea_names: List[str],
    lab_names: List[str],
    max_seq_length: int,
    fea_only: bool = False,
    shuffle_frames: bool = False,
    seed: int = 0,
    fea_lst_override: Optional[Dict[str, str]] = None,
) -> ChunkData:
    """Assemble the full multi-stream chunk (reference read_lab_fea,
    data_io.py:522-647): per-stream load, cw_max compensation, column stack,
    consistency checks, optional frame shuffle."""
    feas = [dataset.features[n] for n in fea_names]
    if fea_lst_override:
        import dataclasses

        feas = [
            dataclasses.replace(f, lst=fea_lst_override.get(f.name, f.lst))
            for f in feas
        ]
    labs = [dataset.labels[n] for n in lab_names] if not fea_only else []
    cw_left_max = max(f.cw_left for f in feas)
    cw_right_max = max(f.cw_right for f in feas)

    data_set = None
    all_labs: List[np.ndarray] = []
    names = end_index = lab_end_index = None
    fea_layout: Dict[str, Tuple[int, int]] = {}
    col = 0
    for fi, fea in enumerate(feas):
        # stream fi is loaded against every label only for fi == 0 (that
        # pass yields all_labs and the cross-checks); additional feature
        # streams only need one pass against lab 0 — the (fi>0, li>0)
        # combinations the reference also loads (data_io.py:551-564) are
        # full ark reads + splice + CMVN whose result is thrown away, and
        # their consistency is implied by the (0, li) and (fi, 0) checks
        if labs:
            lab_sources = labs if fi == 0 else labs[:1]
        else:
            lab_sources = [None]
        for li, lab in enumerate(lab_sources):
            n_, f_, l_, e_, le_ = load_chunk_stream(
                fea, lab, max_seq_length, fea_only
            )
            rates_differ = not np.array_equal(e_, le_)
            # compensate different context windows across streams
            # (data_io.py:577-581)
            lo = cw_left_max - fea.cw_left
            hi = f_.shape[0] - (cw_right_max - fea.cw_right)
            f_ = f_[lo:hi]
            if not rates_differ:
                l_ = l_[lo:hi]
            e_ = e_ - lo
            e_[-1] = e_[-1] - (cw_right_max - fea.cw_right)
            if fi == 0 and li == 0:
                names, end_index = n_, e_
                lab_end_index = e_ if not rates_differ else le_
            else:
                if n_ != names:
                    raise ValueError(
                        "different sentence sets across feature/label streams"
                    )
                if not np.array_equal(e_, end_index):
                    raise ValueError("end indexes differ across streams")
            if li == 0:
                data_set = f_ if data_set is None else np.column_stack((data_set, f_))
                fea_layout[fea.name] = (col, col + f_.shape[1])
            if fi == 0 and not fea_only:
                all_labs.append(l_)
        col = fea_layout[fea.name][1]

    lab_layout = {lab.name: i for i, lab in enumerate(labs)}
    labs_arr = (
        np.stack(all_labs, axis=1).astype(np.int64)
        if all_labs
        else np.zeros((0, 0), dtype=np.int64)
    )

    chunk = ChunkData(
        names=names,
        feats=np.ascontiguousarray(data_set, dtype=np.float32),
        labs=labs_arr,
        end_index=np.asarray(end_index),
        fea_layout=fea_layout,
        lab_layout=lab_layout,
        lab_end_index=np.asarray(lab_end_index),
        window_shift=_chunk_config(max_seq_length)["window_shift"],
        window_size=_chunk_config(max_seq_length)["window_size"],
    )
    if shuffle_frames:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(chunk.n_frames)
        chunk.feats = chunk.feats[perm]
        if chunk.labs.size:
            chunk.labs = chunk.labs[perm]
        chunk.shuffled = True
    return chunk
