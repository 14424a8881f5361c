"""Kaldi TransitionModel parser: native ali-to-pdf / ali-to-phones / hmm-info.

The reference reaches these three Kaldi binaries through shell pipes
(data_io.py:44-51 label generation, utils.py:613-722 hmm-info for the
N_out_* auto-substitution).  This module parses the binary head of a
`final.mdl` directly — the HmmTopology and the transition tuples — and
derives the transition-id -> pdf-id / phone maps, so label streams and
output-layer sizes work without a Kaldi installation.

Binary layout parsed (Kaldi transition-model.cc / hmm-topology.cc Write):

  \\0B <TransitionModel> <Topology>
    phones: int32 vector, phone2idx: int32 vector,
    n_entries (negative => per-state self-loop pdf classes present),
    per entry: n_states x { forward_pdf_class [, self_loop_pdf_class],
                            n_transitions x (next_state int32, prob float) }
  </Topology>
  <Triples>|<Tuples> n x (phone, hmm_state, forward_pdf [, self_loop_pdf])
  </Triples>|</Tuples>
  <LogProbs> float vector </LogProbs> </TransitionModel>

Transition-id numbering follows Kaldi's ComputeDerived(): ids are 1-based,
contiguous per transition-state, one id per topology transition of that
state; an id maps to self_loop_pdf iff its transition is the self-loop.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

from .kaldi_io import KaldiIOError


def _read_token(fd: BinaryIO) -> str:
    chars = []
    while True:
        c = fd.read(1)
        if c in (b"", b" "):
            break
        chars.append(c)
    return b"".join(chars).decode("latin1")


def _expect_token(fd: BinaryIO, want: str) -> None:
    got = _read_token(fd)
    if got != want:
        raise KaldiIOError(f"expected token {want!r}, got {got!r}")


from .kaldi_io import _read_int32 as _read_basic_int  # same wire format


def _read_basic_float(fd: BinaryIO) -> float:
    size = fd.read(1)
    if size != b"\x04":
        raise KaldiIOError(f"expected float size byte, got {size!r}")
    return struct.unpack("<f", fd.read(4))[0]


def _read_int_vector(fd: BinaryIO) -> List[int]:
    """Kaldi WriteIntegerVector format: one element-size byte (\\x04), raw
    int32 count, then the elements as one raw block.  (Alignment arks use a
    different per-element format — see kaldi_io.read_vec_int.)"""
    size = fd.read(1)
    if size != b"\x04":
        raise KaldiIOError(f"expected int-vector size byte, got {size!r}")
    n = struct.unpack("<i", fd.read(4))[0]
    if n == 0:
        return []
    return list(np.frombuffer(fd.read(4 * n), dtype="<i4"))


@dataclass
class HmmState:
    forward_pdf_class: int
    self_loop_pdf_class: int
    transitions: List[Tuple[int, float]]  # (next_state, prob)


@dataclass
class TransitionModel:
    phones: List[int]
    topology: Dict[int, List[HmmState]]  # phone -> states (minus final)
    tuples: List[Tuple[int, int, int, int]]  # (phone, state, fwd_pdf, self_pdf)
    id2pdf: np.ndarray  # 1-based transition-id -> pdf
    id2phone: np.ndarray  # 1-based transition-id -> phone

    @property
    def num_pdfs(self) -> int:
        return int(
            max(max(t[2], t[3]) for t in self.tuples) + 1 if self.tuples else 0
        )

    @property
    def num_phones(self) -> int:
        return len(self.phones)

    @property
    def num_transition_ids(self) -> int:
        return len(self.id2pdf) - 1

    def transition_ids_to_pdfs(self, ali: np.ndarray) -> np.ndarray:
        """Native `ali-to-pdf` (alignment of transition-ids -> pdf-ids)."""
        return self.id2pdf[np.asarray(ali, dtype=np.int64)]

    def transition_ids_to_phones(self, ali: np.ndarray) -> np.ndarray:
        """Native `ali-to-phones --per-frame=true`."""
        return self.id2phone[np.asarray(ali, dtype=np.int64)]


def read_transition_model(path_or_fd) -> TransitionModel:
    fd = open(path_or_fd, "rb") if isinstance(path_or_fd, str) else path_or_fd
    close = isinstance(path_or_fd, str)
    try:
        if fd.read(2) != b"\x00B":
            raise KaldiIOError(
                "final.mdl is not binary; convert with Kaldi's copy-transition-model"
            )
        _expect_token(fd, "<TransitionModel>")
        _expect_token(fd, "<Topology>")
        phones = _read_int_vector(fd)
        phone2idx = _read_int_vector(fd)
        n_entries = _read_basic_int(fd)
        is_hmm = n_entries > 0
        n_entries = abs(n_entries)
        entries: List[List[HmmState]] = []
        for _ in range(n_entries):
            n_states = _read_basic_int(fd)
            states = []
            for _ in range(n_states):
                fwd = _read_basic_int(fd)
                self_loop = fwd if is_hmm else _read_basic_int(fd)
                n_trans = _read_basic_int(fd)
                trans = []
                for _ in range(n_trans):
                    nxt = _read_basic_int(fd)
                    prob = _read_basic_float(fd)
                    trans.append((nxt, prob))
                states.append(HmmState(fwd, self_loop, trans))
            entries.append(states)
        _expect_token(fd, "</Topology>")

        tok = _read_token(fd)
        if tok not in ("<Triples>", "<Tuples>"):
            raise KaldiIOError(f"expected <Triples>/<Tuples>, got {tok!r}")
        with_self = tok == "<Tuples>"
        n_tuples = _read_basic_int(fd)
        tuples = []
        for _ in range(n_tuples):
            phone = _read_basic_int(fd)
            state = _read_basic_int(fd)
            fwd_pdf = _read_basic_int(fd)
            self_pdf = _read_basic_int(fd) if with_self else fwd_pdf
            tuples.append((phone, state, fwd_pdf, self_pdf))
        _expect_token(fd, "</Triples>" if tok == "<Triples>" else "</Tuples>")
        # LogProbs follow; not needed for the id maps — stop parsing here.

        topology = {
            p: entries[phone2idx[p]] for p in phones
        }

        # derive id -> pdf/phone (ComputeDerived semantics)
        id2pdf = [0]  # index 0 unused (ids are 1-based)
        id2phone = [0]
        for phone, state, fwd_pdf, self_pdf in tuples:
            topo_states = topology[phone]
            for next_state, _prob in topo_states[state].transitions:
                is_self_loop = next_state == state
                id2pdf.append(self_pdf if is_self_loop else fwd_pdf)
                id2phone.append(phone)
        return TransitionModel(
            phones=phones,
            topology=topology,
            tuples=tuples,
            id2pdf=np.asarray(id2pdf, dtype=np.int64),
            id2phone=np.asarray(id2phone, dtype=np.int64),
        )
    finally:
        if close:
            fd.close()


def hmm_info(path: str) -> Dict[str, int]:
    """Native `hmm-info`: pdf/phone/transition counts from final.mdl
    (reference consumes this via run_shell at utils.py:621,667)."""
    tm = read_transition_model(path)
    return {
        "number of phones": tm.num_phones,
        "number of pdfs": tm.num_pdfs,
        "number of transition-ids": tm.num_transition_ids,
        "number of transition-states": len(tm.tuples),
    }


def write_transition_model(tm: TransitionModel, path: str) -> None:
    """Write a binary final.mdl head (topology + tuples + uniform log-probs)
    — primarily for tests and synthetic fixtures."""
    with open(path, "wb") as fd:
        fd.write(b"\x00B")

        def token(t):
            fd.write(t.encode() + b" ")

        def bint(v):
            fd.write(b"\x04" + struct.pack("<i", v))

        def bfloat(v):
            fd.write(b"\x04" + struct.pack("<f", v))

        def bintvec(vec):
            # WriteIntegerVector layout: size byte, raw count, raw block
            fd.write(b"\x04" + struct.pack("<i", len(vec)))
            fd.write(np.asarray(vec, dtype="<i4").tobytes())

        token("<TransitionModel>")
        token("<Topology>")
        phones = tm.phones
        max_phone = max(phones)
        phone2idx = [-1] * (max_phone + 1)
        entries = []
        for p in phones:
            entry = tm.topology[p]
            if entry not in entries:
                entries.append(entry)
            phone2idx[p] = entries.index(entry)
        bintvec(phones)
        bintvec(phone2idx)
        is_hmm = all(
            s.forward_pdf_class == s.self_loop_pdf_class
            for e in entries
            for s in e
        )
        bint(len(entries) if is_hmm else -len(entries))
        for entry in entries:
            bint(len(entry))
            for s in entry:
                bint(s.forward_pdf_class)
                if not is_hmm:
                    bint(s.self_loop_pdf_class)
                bint(len(s.transitions))
                for nxt, prob in s.transitions:
                    bint(nxt)
                    bfloat(prob)
        token("</Topology>")
        all_hmm = all(t[2] == t[3] for t in tm.tuples)
        token("<Triples>" if all_hmm else "<Tuples>")
        bint(len(tm.tuples))
        for phone, state, fwd, selfp in tm.tuples:
            bint(phone)
            bint(state)
            bint(fwd)
            if not all_hmm:
                bint(selfp)
        token("</Triples>" if all_hmm else "</Tuples>")
        token("<LogProbs>")
        fd.write(b"FV ")
        n_ids = tm.num_transition_ids + 1
        bint(n_ids)
        fd.write(np.zeros(n_ids, dtype="<f4").tobytes())
        token("</LogProbs>")
        token("</TransitionModel>")
