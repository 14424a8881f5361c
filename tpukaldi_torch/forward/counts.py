"""Prior-count resolution — the native `analyze-counts` path.

The reference auto-generates prior-count files from the training
alignments via `analyze-counts` piped through `ali-to-pdf` when
`normalize_with_counts_from` names a label with `lab_count_file=auto`
(utils.py:655-695).  Here the counts come from the same label stream read
natively (transition-model parser / pre-dumped arks) and are written to the
same `exp_files/forward_<out>_<lab>.count` location; an explicit
`lab_count_file` path or a direct file path in `normalize_with_counts_from`
is used as-is.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config.cfg import ExperimentConfig, LabelSpec, resolve_n_out
from ..data.labels import read_label_stream
from ..io.feats import save_counts


def _find_label(exp: ExperimentConfig, lab_name: str) -> Optional[LabelSpec]:
    for ds_name in list(exp.train_with) + list(exp.datasets):
        ds = exp.datasets.get(ds_name)
        if ds and lab_name in ds.labels:
            return ds.labels[lab_name]
    return None


def generate_counts_from_labels(lab: LabelSpec, path: str) -> str:
    """Accumulate class counts over the label stream and write the count
    file.  Zero counts are floored at 1 so log-priors stay finite
    (analyze-counts would emit 0 for unseen pdfs; -inf priors would then
    make unseen classes win every frame)."""
    labels = read_label_stream(lab.folder, lab.opts)
    n_out = resolve_n_out(lab)
    if n_out is None:
        n_out = int(max(v.max() for v in labels.values())) + 1
    counts = np.zeros(n_out, dtype=np.float64)
    for vec in labels.values():
        counts += np.bincount(np.asarray(vec, dtype=np.int64), minlength=n_out)
    save_counts(np.maximum(counts, 1.0), path)
    return path


def resolve_count_files(exp: ExperimentConfig, exp_files: str) -> None:
    """Rewrite exp.forward.counts_from entries that name labels into real
    count-file paths, generating them when lab_count_file=auto."""
    for i, src in enumerate(exp.forward.counts_from):
        if not exp.forward.normalize_posteriors[i]:
            continue
        if os.path.isfile(src):
            continue
        lab = _find_label(exp, src)
        if lab is None:
            raise FileNotFoundError(
                f"normalize_with_counts_from={src!r} is neither a count file "
                f"nor a known label name"
            )
        if lab.count_file not in ("auto", "none", ""):
            # an explicitly configured count file that is missing must be
            # an error, not a silent fall-through to auto-generation:
            # label-derived counts differ from e.g. a smoothed Kaldi
            # analyze-counts file, which would silently shift the decode
            # priors the user asked for
            if not os.path.isfile(lab.count_file):
                raise FileNotFoundError(
                    f"lab_count_file={lab.count_file!r} (for label "
                    f"{src!r}) does not exist"
                )
            exp.forward.counts_from[i] = lab.count_file
            continue
        out_name = exp.forward.outs[min(i, len(exp.forward.outs) - 1)]
        path = os.path.join(exp_files, f"forward_{out_name}_{src}.count")
        if not os.path.isfile(path):
            generate_counts_from_labels(lab, path)
        exp.forward.counts_from[i] = path
