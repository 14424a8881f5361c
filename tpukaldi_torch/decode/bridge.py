"""Decoding bridge: posterior arks -> Kaldi WFST decoding -> WER/PER.

The reference shells out to kaldi_decoding_scripts/decode_dnn.sh with a
generated decoding conf (run_exp.py:534-621) and scrapes the best WER from
the scoring output (check_res_dec.sh / best_wer.sh).  Decoding stays
delegated to the read-only Kaldi install (the posterior ark is the parity
contract, SURVEY.md §2.3); this bridge builds the same conf, invokes the
script when present, and harvests WER lines natively (no perl).
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional

from ..config.cfg import DecodingSpec, ExperimentConfig, LabelSpec


def write_decoding_conf(
    path: str,
    decoding: DecodingSpec,
    lab: LabelSpec,
    out_folder: str,
) -> str:
    """Emit the `decoding_<...>.conf` the decode script expects
    (reference run_exp.py:559-586: [decoding] options + alidir/data/graphdir
    derived from the label section)."""
    with open(path, "w") as f:
        f.write("[decoding]\n")
        for key, value in decoding.options.items():
            f.write(f"{key} = {value}\n")
        f.write(f"alidir = {os.path.abspath(lab.folder)}\n")
        f.write(f"data = {os.path.abspath(lab.data_folder)}\n")
        f.write(f"graphdir = {os.path.abspath(lab.graph)}\n")
        f.write(f"out_folder = {out_folder}\n")
    return path


def run_decode(
    exp: ExperimentConfig,
    lab: LabelSpec,
    out_name: str,
    forward_data: str,
    ark_files: List[str],
    log_file: str,
) -> Optional[str]:
    """Invoke the Kaldi decode script over the posterior arks; returns the
    decode output dir, or None when Kaldi isn't available (logged)."""
    dec = exp.decoding
    script = os.path.join(dec.script_folder, dec.script) if dec.script else ""
    if dec.script and not os.path.isfile(script):
        # the framework ships its own decode/scoring scripts (same call
        # contract as the reference's kaldi_decoding_scripts/) so a recipe
        # pointing at a non-existent external folder still decodes — but
        # only when the Kaldi binaries the shipped driver runs are actually
        # installed; otherwise keep the soft-skip (posteriors stay on disk)
        shipped = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts", dec.script
        )
        if os.path.isfile(shipped) and shutil.which("latgen-faster-mapped"):
            with open(log_file, "a") as f:
                f.write(
                    f"[decode] {script!r} not found; using the shipped "
                    f"script {shipped!r}\n"
                )
            script = shipped
    out_dec_folder = os.path.join(
        exp.out_folder, f"decode_{forward_data}_{out_name}"
    )
    if not script or not os.path.isfile(script) or not shutil.which("bash"):
        with open(log_file, "a") as f:
            f.write(
                f"[decode] skipped: decoding script {script!r} unavailable; "
                f"posterior arks ready at {ark_files}\n"
            )
        return None
    conf = write_decoding_conf(
        os.path.join(
            exp.out_folder, f"decoding_{forward_data}_{out_name}.conf"
        ),
        dec,
        lab,
        out_dec_folder,
    )
    cmd = [script, conf, out_dec_folder, " ".join(os.path.abspath(a) for a in ark_files)]
    if getattr(exp, "cmd", ""):
        # [exp] cmd launcher prefix (queue.pl / slurm wrapper), reference
        # run_exp.py:595 prepends it to the decode command line
        cmd = exp.cmd.split() + cmd
    with open(log_file, "a") as f:
        result = subprocess.run(cmd, stdout=f, stderr=f)
    if result.returncode != 0:
        raise RuntimeError(f"decode script failed (see {log_file})")
    return out_dec_folder


# kaldi compute-wer line: "%WER 18.10 [ 1234 / 6819, 123 ins, 456 del, ...]"
# (WER only — compute-wer also writes %SER lines, which best_wer.sh's
# `grep WER` ignores; matching them could report a sentence error rate)
_KALDI_WER_RE = re.compile(r"%WER\s+(\d+\.?\d*)")
# sclite .sys summary row: "| Sum/Avg | 192 7215 | 82.1 12.6 5.3 2.6 20.5 ...|"
_SCLITE_RE = re.compile(
    r"(?:Mean|Sum/Avg)\s*\|\s*\S+\s+\S+\s*\|\s*\S+\s+\S+\s+\S+\s+\S+\s+(\S+)\s+\S+\s*\|"
)


def harvest_wer(decode_dir: str) -> Optional[Dict[str, object]]:
    """Native replacement for check_res_dec.sh -> best_wer.sh: scan the
    scoring outputs (kaldi `wer_<lmwt>` files and sclite `score_*/ *.sys`
    summaries), pick the best WER over LM weights, and return the FULL best
    line — including ins/del/sub detail — plus the file it came from
    (reference best_wer.sh:20-29 reports the whole line, not just the
    number)."""
    best = None

    def consider(wer: float, line: str, path: str):
        nonlocal best
        if best is None or wer < best["wer"]:
            best = {"wer": wer, "file": path, "line": f"{line.strip()} {path}"}

    for path in sorted(glob.glob(os.path.join(decode_dir, "wer_*"))):
        try:
            with open(path, errors="ignore") as f:
                for line in f:
                    m = _KALDI_WER_RE.search(line)
                    if m:
                        consider(float(m.group(1)), line, path)
        except OSError:
            continue
    for path in sorted(glob.glob(os.path.join(decode_dir, "score_*", "*.sys"))):
        try:
            with open(path, errors="ignore") as f:
                for line in f:
                    m = _SCLITE_RE.search(line)
                    if m:
                        consider(
                            float(m.group(1)), f"%WER {m.group(1)} {line}", path
                        )
        except OSError:
            continue
    return best
