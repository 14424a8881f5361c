"""K1f, K2f, K3f and K4f across their envelope (1 <= H <= 2048), on the card.

    python -m tpukaldi_torch.tools.recurrence_envelope [--before DIR]

At every shape of `OLD_SHAPES` (chip_smoke.py's recipe and edge shapes of
the forward recurrences, H <= 1024: every CTA's slice of U resident) and
`NEW_SHAPES` (chip_smoke.py's `WIDE_FWD_SHAPES`: H = 1036, 1536 and 2048,
where the slices of all but the liGRU's at 1036 and 1536 are streamed past
their resident rows, `csrc/u_stream.cuh`), each forward kernel as built
against its plain version: K1f, K2f, K3f (tanh and relu) within ATOL; K4f,
through its float32-ff and its bf16-ff entry, within LEAN_SEQ_ATOL and, step
by step from its own previous state, within LEAN_STEP_ATOL; two calls
bitwise equal.  Each shape prints each kernel's plan: its grid, shared
memory, chunk, the rows of U a CTA keeps resident and the bytes of U the
grid streams a step.

Two more builds of the four sources run the streamed design where the
whole slice fits, at the shapes of at most 50 steps, held to the plain
versions the same way: `stream forced` (the resident rows as many whole
chunks as fit, the rest streamed) and `all streamed, chunk 16` (no
resident row, 16-row chunks: the most chunks, and a last chunk with the
depth's zero rows at every H not a multiple of 16).

With `--before DIR` (e.g. the parent commit's `csrc`, from `git archive
<parent> tpukaldi_torch/kernels/csrc` unpacked under `build/`), DIR's four
sources and headers built as they are: at `OLD_SHAPES` every output
bitwise DIR's, and the four kernels timed at the recipe shapes
(`TIMED`) in turns, DIR's, as built, as built, DIR's.  Then each kernel
and its plain version timed at `NEW_SHAPES`.

Prints the card's name and power limit and ptxas's registers of each
build; exits 1 on any disagreement.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import torch

from ..kernels import _build, gru, ligru, lstm
from ..train.chunk_runtime import resolve_device
from .variant_builds import Use, build_variants, median_ms, sources

SRCS = (ligru.SOURCE, lstm.SOURCE, gru.SOURCE, lstm.LEAN_SOURCE)
FILES = SRCS + ("persist_grid.cuh", "u_stream.cuh", "gru_slices.cuh",
                "mma_bf16.cuh", "lstm_lean_cell.cuh")
# chip_smoke.py's FWD_SHAPES, FWD_EDGE_SHAPES (K1f-K3f), GRU_RELU_FWD_SHAPES,
# LEAN_FWD_SHAPES and LEAN_FWD_EDGE_SHAPES (K4f), and WIDE_FWD_SHAPES (all)
OLD_SHAPES = {
    "K1f": ((778, 64, 550), (1000, 16, 550), (37, 5, 36), (50, 136, 550),
            (50, 96, 1024)),
    "K4f": ((778, 64, 1024), (1000, 32, 1024), (37, 5, 36), (50, 96, 1024)),
}
OLD_SHAPES["K2f"] = OLD_SHAPES["K3f"] = OLD_SHAPES["K1f"]
NEW_SHAPES = ((778, 16, 2048), (50, 64, 2048), (50, 5, 1036), (50, 16, 1536))
TIMED = {"K1f": ((778, 64, 550), (1000, 16, 550)),
         "K4f": ((778, 64, 1024), (1000, 32, 1024))}
TIMED["K2f"] = TIMED["K3f"] = TIMED["K1f"]
VARIANT_MAX_T = 50
# chip_smoke.py's KERNEL_ATOL, LEAN_SEQ_ATOL and LEAN_STEP_ATOL
ATOL, LEAN_SEQ_ATOL, LEAN_STEP_ATOL = 1e-4, 2e-3, 1e-5
# the resident design's check in each make_plan, and the resident rows
RESIDENT_CHECK = "if (pl->smem > static_cast<size_t>(optin)) {"
RESIDENT_ROWS = "*k_res = fit < below ? fit : below;"
STREAM_CHUNK = "constexpr int kStreamChunk = 128;"


def _variant(files: Dict[str, str], all_streamed: bool) -> Dict[str, str]:
    out = dict(files)
    for src in SRCS:
        if out[src].count(RESIDENT_CHECK) != 1:
            raise RuntimeError(f"{src}: the resident check is not one line")
        out[src] = out[src].replace(RESIDENT_CHECK, "if (true) {")
    if all_streamed:
        text = out["u_stream.cuh"]
        if text.count(RESIDENT_ROWS) != 1 or text.count(STREAM_CHUNK) != 1:
            raise RuntimeError("u_stream.cuh: the lines to replace moved")
        out["u_stream.cuh"] = text.replace(RESIDENT_ROWS, "*k_res = 0;").replace(
            STREAM_CHUNK, "constexpr int kStreamChunk = 16;")
    return out


def _inputs(n_gates: int, T: int, B: int, H: int, seed: int):
    """ff, orthogonal (H, H) blocks of U side by side and a 0/1 mask, on
    the card, as chip_smoke.py's kernel phase draws them (its blocks by
    torch.nn.init.orthogonal_, here by QR on the card)."""
    g = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, n_gates * H, generator=g).cuda()
    a = torch.randn(n_gates, H, H, generator=g).cuda()
    q, r = torch.linalg.qr(a)
    u = torch.cat(list(q * torch.sign(torch.diagonal(r, dim1=1, dim2=2))
                       .unsqueeze(1)), dim=1)
    mask = (torch.rand(B, H, generator=g) < 0.8).float().cuda()
    return ff, u.contiguous(), mask


def _lean_step_error(ff, u, mask, h, c) -> float:
    """K4f's h and c at every step against one plain bf16 step from the
    kernel's own state of the step before (chip_smoke.py's)."""
    T, B, H4 = ff.shape
    H = H4 // 4
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    zeros = h.new_zeros((1, B, H))
    h_prev, c_prev = torch.cat([zeros, h[:-1]]), torch.cat([zeros, c[:-1]])
    a = ff + (bf(h_prev).reshape(T * B, H) @ bf(u)).reshape(T, B, H4)
    f, i, o = (torch.sigmoid(a[..., k * H:(k + 1) * H]) for k in range(3))
    c_step = i * torch.tanh(a[..., 3 * H:]) * mask + f * c_prev
    return max((h - o * torch.tanh(c_step)).abs().max().item(),
               (c - c_step).abs().max().item())


def _calls(name: str, T: int, B: int, H: int
           ) -> Dict[str, Tuple[Callable, Callable, Callable, tuple]]:
    """label -> (kernel call, plain call, plan, its inputs) of one kernel
    at one shape."""
    if name == "K1f":
        ff, u, mask = _inputs(2, T, B, H, T + B)
        return {"K1f": (lambda: (ligru.ligru_recurrence(ff, u, mask),),
                        lambda: (ligru.ligru_recurrence_ref(ff, u, mask),),
                        ligru.fwd_plan, ())}
    if name == "K2f":
        ff, u, mask = _inputs(4, T, B, H, T + B)
        return {"K2f": (lambda: lstm.lstm_recurrence(ff, u, mask),
                        lambda: lstm.lstm_recurrence_ref(ff, u, mask),
                        lstm.fwd_plan, ())}
    if name == "K3f":
        ff, u, mask = _inputs(3, T, B, H, T + B)
        uzr, uh = u[:, :2 * H].contiguous(), u[:, 2 * H:].contiguous()
        return {f"K3f {act}": (
            lambda act=act: (gru.gru_recurrence(ff, uzr, uh, mask, act),),
            lambda act=act: (gru.gru_recurrence_ref(ff, uzr, uh, mask, act),),
            gru.fwd_plan, ()) for act in ("tanh", "relu")}
    ff, u, mask = _inputs(4, T, B, H, T + B)
    ff16 = ff.to(torch.bfloat16)
    return {label: (lambda x=x: lstm.lstm_recurrence_lean(x, u, mask),
                    lambda x=x: lstm.lstm_recurrence_lean_ref(x, u, mask),
                    lstm.lean_fwd_plan, (x.float(), u, mask))
            for label, x in (("K4f", ff), ("K4f bf16 ff", ff16))}


def _check(label, got, want, lean_ins) -> List[str]:
    """What disagrees with the plain version, one line each."""
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    atol = LEAN_SEQ_ATOL if lean_ins else ATOL
    bad = [] if err <= atol else [f"{label} err {err:.3e} (atol {atol:g})"]
    if lean_ins:
        step = _lean_step_error(*lean_ins, *got)
        if not step <= LEAN_STEP_ATOL:
            bad.append(f"{label} step err {step:.3e}")
    return bad


def _plan_line(plan: dict) -> str:
    return (f"P={plan['ctas']} u={plan['units']} smem={plan['smem_bytes']} "
            f"chunk={plan['chunk']} k_res={plan['k_res']} "
            f"stream_bytes={plan['stream_bytes']}")


def _regs(name: str, libs) -> None:
    for src in SRCS:
        with open(libs[src]._name + ".txt") as f:
            report = f.read()
        regs = [line.split(":", 1)[1].strip() for line in report.splitlines()
                if "registers" in line]
        print(f"{name} {src}: {'; '.join(regs)}", flush=True)


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    files = sources(_build._CSRC, FILES)
    builds = {"stream forced": _variant(files, False),
              "all streamed, chunk 16": _variant(files, True)}
    if argv[:1] == ["--before"]:
        builds["before"] = sources(argv[1], FILES)
    libs = build_variants(builds, "recurrence_envelope", SRCS)
    built = {src: _build.load(src) for src in SRCS}
    _regs("as built", built)
    before = libs.pop("before", None)
    bad = 0
    with torch.inference_mode():
        for name in ("K1f", "K2f", "K3f", "K4f"):
            for shape in OLD_SHAPES[name] + NEW_SHAPES:
                for label, (fn, plain, plan, lean_ins) in _calls(
                        name, *shape).items():
                    with Use(built):
                        got, repeat = fn(), fn()
                        line = _plan_line(plan(*shape[1:]))
                    want = plain()
                    problems = _check(label, got, want, lean_ins)
                    if not all(torch.equal(a, b) for a, b in zip(got, repeat)):
                        problems.append(f"{label} differs on a repeat")
                    if before is not None and shape in OLD_SHAPES[name]:
                        with Use(before):
                            old = fn()
                        if not all(torch.equal(a, b) for a, b in zip(got, old)):
                            problems.append(f"{label} differs from the before "
                                            "build")
                    for vname, vlibs in libs.items():
                        if shape[0] <= VARIANT_MAX_T:
                            with Use(vlibs):
                                v = fn()
                                vline = _plan_line(plan(*shape[1:]))
                            problems += [f"{vname}: {p}" for p in
                                         _check(label, v, want, lean_ins)]
                            line += f"; {vname}: {vline}"
                    print(f"{label} T={shape[0]} B={shape[1]} H={shape[2]}"
                          + (", bitwise the before build" if before is not None
                             and shape in OLD_SHAPES[name] else "")
                          + f": {'; '.join(problems) or 'ok'}; {line}",
                          flush=True)
                    bad += bool(problems)
        for name in ("K1f", "K2f", "K3f", "K4f"):
            for shape in TIMED[name] + NEW_SHAPES:
                for label, (fn, plain, _, _) in _calls(name, *shape).items():
                    tag = f"{label} T={shape[0]} B={shape[1]} H={shape[2]}"
                    if shape in TIMED[name]:
                        if before is None:
                            continue
                        t = []
                        for lib in (before, built, built, before):
                            with Use(lib):
                                t.append(median_ms(fn, 5))
                        print(f"time {tag}: before {t[0]:.4f} {t[3]:.4f}, as "
                              f"built {t[1]:.4f} {t[2]:.4f} ms (as built / "
                              f"before {(t[1] + t[2]) / (t[0] + t[3]):.3f})",
                              flush=True)
                    else:
                        with Use(built):
                            t = [median_ms(fn, 5) for _ in range(2)]
                        print(f"time {tag}: as built {t[0]:.4f} {t[1]:.4f} "
                              f"ms; plain {median_ms(plain, 3):.4f} ms",
                              flush=True)
    print(f"{bad} kernel shapes disagree", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
