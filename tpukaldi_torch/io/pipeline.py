"""Native interpreter for Kaldi `fea_opts` / `lab_opts` shell pipelines.

The reference pipes every feature read through Kaldi binaries
(`"ark:copy-feats scp:... ark:- |" + fea_opts`, data_io.py:39-42).  Here the
pipeline string from the cfg (e.g.
``apply-cmvn --utt2spk=ark:u2s ark:cmvn.ark ark:- ark:- | add-deltas
--delta-order=2 ark:- ark:- |``) is parsed once and each stage is executed
natively on the host — no subprocess in the data path.  Unknown stages fall
back to the real binary via subprocess iff it exists on PATH (keeps full
compatibility with exotic Kaldi front-ends).
"""

from __future__ import annotations

import shlex
import shutil
import subprocess
from typing import Callable, Dict, List

import numpy as np

from . import feats as F
from . import kaldi_io as kio

Stage = Callable[[str, np.ndarray], np.ndarray]


def _read_utt2spk(path: str) -> Dict[str, str]:
    mapping = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                mapping[parts[0]] = parts[1]
    return mapping


def _strip_rxspec(arg: str) -> str:
    """'ark:/path' / 'scp:/path' -> '/path'."""
    for prefix in ("ark,t:", "scp,t:", "ark:", "scp:"):
        if arg.startswith(prefix):
            return arg[len(prefix) :]
    return arg


def _parse_kv_opts(args: List[str]):
    opts, positional = {}, []
    for a in args:
        if a.startswith("--"):
            key, _, val = a[2:].partition("=")
            opts[key.replace("-", "_")] = val if val else "true"
        else:
            positional.append(a)
    return opts, positional


def _make_apply_cmvn(args: List[str]) -> Stage:
    opts, positional = _parse_kv_opts(args)
    norm_vars = opts.get("norm_vars", "false").lower() in ("true", "1")
    utt2spk = (
        _read_utt2spk(_strip_rxspec(opts["utt2spk"])) if "utt2spk" in opts else None
    )
    # positional: <cmvn-stats-rspec> <in> <out>; in/out are 'ark:-'.
    # Standard Kaldi recipes write per-speaker cmvn stats behind an scp
    # (steps/compute_cmvn_stats.sh -> cmvn.scp); honor the indirection
    # instead of misparsing the scp text as an ark.
    rspec = positional[0]
    stats_path = _strip_rxspec(rspec)
    if rspec.startswith(("scp:", "scp,t:")):
        from .kaldi_io import read_mat_scp

        stats = {k: m for k, m in read_mat_scp(stats_path)}
    else:
        stats = F.read_cmvn_stats(stats_path)

    def stage(key: str, mat: np.ndarray) -> np.ndarray:
        spk = utt2spk.get(key, key) if utt2spk is not None else key
        if spk not in stats:
            raise KeyError(f"no cmvn stats for speaker {spk!r} (utt {key!r})")
        return F.apply_cmvn(mat, stats[spk], norm_vars=norm_vars)

    return stage


def _make_add_deltas(args: List[str]) -> Stage:
    opts, _ = _parse_kv_opts(args)
    order = int(opts.get("delta_order", 2))
    window = int(opts.get("delta_window", 2))

    def stage(key: str, mat: np.ndarray) -> np.ndarray:
        return F.add_deltas(mat, order=order, window=window)

    return stage


def _make_splice(args: List[str]) -> Stage:
    opts, _ = _parse_kv_opts(args)
    left = int(opts.get("left_context", 4))
    right = int(opts.get("right_context", 4))

    def stage(key: str, mat: np.ndarray) -> np.ndarray:
        # splice-feats replicates edges (unlike our chunk-level roll splice)
        n = mat.shape[0]
        cols = []
        for lag in range(-left, right + 1):
            idx = np.clip(np.arange(n) + lag, 0, n - 1)
            cols.append(mat[idx])
        return np.concatenate(cols, axis=1)

    return stage


def _make_copy(args: List[str]) -> Stage:
    return lambda key, mat: mat


def _make_subprocess_stage(cmd: str, args: List[str]) -> Stage:
    """Fallback: stream a single matrix through the real Kaldi binary."""

    def stage(key: str, mat: np.ndarray) -> np.ndarray:
        import io as _io

        buf = _io.BytesIO()
        kio.write_mat(buf, mat, key=key)
        proc = subprocess.run(
            [cmd] + args,
            input=buf.getvalue(),
            stdout=subprocess.PIPE,
            check=True,
        )
        out = _io.BytesIO(proc.stdout)
        _, result = next(kio.read_mat_ark(out))
        return result

    return stage


_NATIVE = {
    "apply-cmvn": _make_apply_cmvn,
    "add-deltas": _make_add_deltas,
    "splice-feats": _make_splice,
    "copy-feats": _make_copy,
    "wav-copy": _make_copy,
}


def parse_pipeline(fea_opts: str) -> List[Stage]:
    """Compile a fea_opts pipeline string into a list of native stages."""
    stages: List[Stage] = []
    for segment in fea_opts.split("|"):
        segment = segment.strip()
        if not segment:
            continue
        parts = shlex.split(segment)
        cmd, args = parts[0], parts[1:]
        if cmd in _NATIVE:
            stages.append(_NATIVE[cmd](args))
        elif shutil.which(cmd):
            stages.append(_make_subprocess_stage(cmd, args))
        else:
            raise ValueError(
                f"unsupported fea_opts stage {cmd!r} (no native impl, not on PATH)"
            )
    return stages


def apply_pipeline(stages: List[Stage], key: str, mat: np.ndarray) -> np.ndarray:
    for stage in stages:
        mat = stage(key, mat)
    return mat
