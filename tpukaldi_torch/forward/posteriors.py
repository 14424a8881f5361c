"""Posterior emission: prior-normalized log-posterior arks for the Kaldi
WFST decoder.

Reference semantics (core.py:660-671): forward mode processes whole
utterances at batch 1, subtracts log-priors `log(counts/sum(counts))` from
the network's log-softmax output when `normalize_posteriors`, and writes a
float32 matrix per utterance into `<info>_<out>_to_decode.ark`.  This file
is the parity contract with `latgen-faster-mapped` (SURVEY.md §6).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..config.cfg import ForwardSpec
from ..io import kaldi_io as kio
from ..io.feats import load_counts


class PosteriorWriter:
    """One ark file per forward output, named off the chunk's info file
    (reference core.py:540-548)."""

    def __init__(self, forward: ForwardSpec, info_file: str,
                 subtract_on_write: bool = True):
        self.forward = forward
        self.files: Dict[str, object] = {}
        self.log_priors: Dict[str, Optional[np.ndarray]] = {}
        self.paths: Dict[str, str] = {}
        # False when the caller fuses the prior subtraction into the device
        # forward step (train/step.py make_forward_step log_priors=...) —
        # write() then just serializes
        self.subtract_on_write = subtract_on_write
        # resolve every prior BEFORE opening any ark: a malformed count
        # file must not leave behind truncated arks that a resumed driver
        # would treat as valid decode inputs
        for i, out in enumerate(forward.outs):
            if forward.normalize_posteriors[i]:
                counts = load_counts(forward.counts_from[i])
                if (counts <= 0).any():
                    msg = (
                        f"count file {forward.counts_from[i]} has "
                        f"{int((counts <= 0).sum())} zero/negative entries; "
                        "the resulting -inf log-priors would dominate every "
                        "frame after subtraction — flooring to 1 (the same "
                        "floor forward/counts.py applies when generating "
                        "counts)"
                    )
                    import logging

                    logging.warning(msg)
                    # also land it in the experiment's log.log (stderr is
                    # lost in detached runs); exp_files/<info> ->
                    # out_folder/log.log
                    try:
                        out_folder = os.path.dirname(
                            os.path.dirname(os.path.abspath(info_file))
                        )
                        with open(os.path.join(out_folder, "log.log"),
                                  "a") as lf:
                            lf.write(f"WARNING: {msg}\n")
                    except OSError:
                        pass
                    counts = np.maximum(counts, 1.0)
                self.log_priors[out] = np.log(counts / counts.sum())
            else:
                self.log_priors[out] = None
        for i, out in enumerate(forward.outs):
            suffix = "_to_decode.ark" if forward.require_decoding[i] else ".ark"
            path = info_file.replace(".info", f"_{out}{suffix}")
            self.paths[out] = path
            self.files[out] = open(path, "wb")
        # TPUKALDI_FORWARD_ARK_CODEC=cm2 writes Kaldi CompressedMatrix
        # format-2 arks (~2x smaller on disk, ~1e-4 relative quantization;
        # latgen reads them transparently).  fm (default) = exact float32,
        # the posterior-parity contract.
        codec = os.environ.get(
            "TPUKALDI_FORWARD_ARK_CODEC", "fm").strip().lower()
        if codec not in ("fm", "cm2", "cm"):
            raise ValueError(
                f"TPUKALDI_FORWARD_ARK_CODEC={codec!r}: use fm or cm2")
        self._write_mat = (
            kio.write_mat_compressed if codec in ("cm2", "cm")
            else kio.write_mat
        )

    def write(self, out_name: str, key: str, log_post: np.ndarray) -> None:
        if self.subtract_on_write:
            prior = self.log_priors[out_name]
            if prior is not None:
                log_post = log_post - prior
        if log_post.dtype != np.float32:
            log_post = log_post.astype(np.float32)
        self._write_mat(self.files[out_name], log_post, key=key)

    def close(self) -> List[str]:
        for f in self.files.values():
            f.close()
        return list(self.paths.values())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
