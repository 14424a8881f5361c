"""Label-stream reading: forced-alignment -> per-frame integer targets.

The reference always shells `gunzip -c lab/ali*.gz | ali-to-pdf final.mdl`
(data_io.py:44-51).  Resolution order here:

1. a pre-dumped label ark (`labels.ark` / `lab.ark` / any `*.pdf.ark`) in the
   folder — our native fast path (one-time dump via Kaldi is allowed by the
   parity contract, SURVEY.md §2.3);
2. the folder itself being an .ark file path;
3. Kaldi `ali-to-pdf` / `ali-to-phones` subprocess when the binaries and
   `ali*.gz` exist (full reference compatibility).
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Dict

import numpy as np

from ..io import kaldi_io as kio

# pre-dumped label arks, resolved by lab_opts so pdf and phone streams
# sharing one alignment folder don't collide
PREDUMPED_PDF = ("labels.ark", "lab.ark", "*.pdf.ark", "*.lab.ark")
PREDUMPED_PHONE = ("labels_phones.ark", "phones.ark", "*.phones.ark",
                   "*.phone.ark")


def read_label_stream(folder: str, opts: str) -> Dict[str, np.ndarray]:
    """Return {utt: int vector} for one label stream."""
    if os.path.isfile(folder):
        return dict(kio.read_vec_int_ark(folder))
    if os.path.isdir(folder):
        is_phone = "ali-to-phones" in (opts or "")

        def _find(patterns):
            for pattern in patterns:
                hits = sorted(glob.glob(os.path.join(folder, pattern)))
                if hits:
                    out: Dict[str, np.ndarray] = {}
                    for hit in hits:
                        out.update(kio.read_vec_int_ark(hit))
                    return out
            return None

        found = _find(PREDUMPED_PHONE if is_phone else PREDUMPED_PDF)
        if found is not None:
            return found
        # raw alignments present: map them exactly per lab_opts
        if glob.glob(os.path.join(folder, "ali*.gz")):
            return _labels_via_kaldi(folder, opts)
        if is_phone:
            # dedicated phone dump absent; a generic dump in a
            # phone-specific folder is taken as that stream's labels
            found = _find(PREDUMPED_PDF)
            if found is not None:
                return found
        return _labels_via_kaldi(folder, opts)
    raise FileNotFoundError(f"label source {folder!r} does not exist")


def _read_ali_archives(ali_files) -> Dict[str, np.ndarray]:
    """gunzip + concatenate alignment archives of transition-ids."""
    import gzip
    import io as _io

    out: Dict[str, np.ndarray] = {}
    for path in ali_files:
        with gzip.open(path, "rb") as f:
            out.update(kio.read_vec_int_ark(_io.BytesIO(f.read())))
    return out


def _labels_via_kaldi(folder: str, opts: str) -> Dict[str, np.ndarray]:
    ali_files = sorted(glob.glob(os.path.join(folder, "ali*.gz")))
    mdl = os.path.join(folder, "final.mdl")
    cmd = (opts or "ali-to-pdf").split()[0]
    if not ali_files or not os.path.isfile(mdl):
        raise FileNotFoundError(
            f"no pre-dumped label ark and no ali*.gz/final.mdl in {folder!r}"
        )
    # native path: parse final.mdl and map transition-ids in-process
    if cmd in ("ali-to-pdf", "ali-to-phones"):
        try:
            from ..io.transition_model import read_transition_model

            tm = read_transition_model(mdl)
            alis = _read_ali_archives(ali_files)
            if cmd == "ali-to-pdf":
                return {k: tm.transition_ids_to_pdfs(v) for k, v in alis.items()}
            return {k: tm.transition_ids_to_phones(v) for k, v in alis.items()}
        except Exception:
            if not shutil.which(cmd):
                raise
    if not shutil.which(cmd):
        raise RuntimeError(
            f"label folder {folder!r} needs Kaldi {cmd!r} which is not on PATH; "
            f"pre-dump labels once with: gunzip -c {folder}/ali*.gz | "
            f"{opts} {mdl} ark:- ark:{folder}/labels.ark"
        )
    import shlex

    # quote every interpolated path: folders with spaces/metacharacters
    # must not split the command or inject into the shell
    shell = (
        f"gunzip -c {' '.join(shlex.quote(a) for a in ali_files)} | "
        f"{opts} {shlex.quote(mdl)} ark:- ark:-"
    )
    proc = subprocess.run(shell, shell=True, stdout=subprocess.PIPE, check=True)
    import io as _io

    return dict(kio.read_vec_int_ark(_io.BytesIO(proc.stdout)))


def dump_label_stream(labels: Dict[str, np.ndarray], path: str) -> None:
    with open(path, "wb") as f:
        for key, vec in labels.items():
            kio.write_vec_int(f, vec, key=key)
