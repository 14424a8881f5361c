"""K1f's step split by phase, and its tiling alternatives, on the card.

    python -m tpukaldi_torch.tools.ligru_fwd_phases [--before FILE] [T,B,H ...]

Builds variants of `kernels/csrc/ligru_fwd.cu` by replacing a line or two
each (`VARIANTS`) and times every variant at each shape (default: the
liGRU recipe's serving and training shapes), in turns, forward then
backward through the list:

- `as built`; `rows 8` (tiles of 8 batch rows), `chunk 128` (columns
  staged at a time), `odd u` (the smallest u, even or odd: u = 5, P = 110
  at H = 550 on 132 SMs, a zero pair in the last word of every row): the
  same arithmetic, held to the plain version (`ligru_recurrence_ref`) and
  to itself (two calls bitwise equal);
- `no product` (the k loop runs no step), `no stream` (no chunk of h is
  staged), `neither`, and `no barriers` (neither, and no grid barrier):
  cut phases, whose outputs are wrong;
- `no steps` (the time loop runs no step: the slice's load and the
  launch);
- with `--before FILE`, `before`: FILE built as it is, a `ligru_fwd.cu` of
  the one-CTA-per-row design (its C entry takes U unpacked and no
  scratch), held to the plain version too;
- `K2f`: the float32 LSTM forward (`lstm.lstm_recurrence`) at the same
  (T, B, H), on LSTM inputs from the same seed, as a yardstick.

A step is (`as built` - `no steps`) / T: its product is `no stream` -
`neither`, its stream `no product` - `neither`, its grid barrier `neither`
- `no barriers`, and `no barriers` - `no steps` is the cell, the ff loads,
the output writes and the rest.  Prints the card's name and power limit
first; exits 1 if a variant with the full arithmetic (or `before`)
disagrees with the plain version, or one of the kernel's own variants
between two calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import List, Tuple

import torch

from ..kernels import _build, ligru, lstm
from ..train.chunk_runtime import resolve_device
from . import lstm_fwd_phases
from .lstm_fwd_phases import _build_all, variants
from .variant_builds import median_ms

SHAPES = ((778, 64, 550), (1000, 16, 550))
ATOL = 1e-4  # as chip_smoke.py's KERNEL_ATOL
_K_LOOP = "          for (int kk = s_thr; kk < ksteps; kk += S) {"
_STAGE = "        for (int i = tid; i < mp * per_row; i += kThreads) {"
_ARRIVE = "      if (more) tpk::grid_arrive(p.bar);"
_WAIT = "        tpk::grid_wait(p.bar, arrived);"
_STEPS = "    for (int t = 0; t < p.T; ++t) {"
_ROWS = "constexpr int kRows = 4;"
_CHUNK = "constexpr int kMaxChunk = 256;"
_EVEN = "  u += u % 2;  // even: no zero pair in the last word of a row"
_NO_PRODUCT = (_K_LOOP, _K_LOOP.replace("kk < ksteps", "kk < 0"))
_NO_STREAM = (_STAGE, _STAGE.replace("i < mp * per_row", "i < 0"))
_NO_BARRIERS = ((_ARRIVE, "      if (more) __syncthreads();"),
                (_WAIT, "        __syncthreads();"))
_NO_STEPS = (_STEPS, _STEPS.replace("t < p.T", "t < 0"))
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "rows 8": (((_ROWS, "constexpr int kRows = 8;"),), True),
    "chunk 128": (((_CHUNK, "constexpr int kMaxChunk = 128;"),), True),
    "odd u": (((_EVEN, ""),), True),
    "no product": ((_NO_PRODUCT,), False),
    "no stream": ((_NO_STREAM,), False),
    "neither": ((_NO_PRODUCT, _NO_STREAM), False),
    "no barriers": ((_NO_PRODUCT, _NO_STREAM, *_NO_BARRIERS), False),
    "no steps": ((_NO_STEPS,), False),
}


def source() -> str:
    """`csrc/ligru_fwd.cu` as it is."""
    with open(os.path.join(_build._CSRC, ligru.SOURCE)) as f:
        return f.read()


def _runner(lib: ctypes.CDLL, ff, u, mask):
    """fn() -> h through `lib`'s C entry, with U packed for the units of
    `lib`'s own plan and the wrapper's scratch (B padded to 8, enough for
    either tile height); a library without a plan is the one-CTA-per-row
    design, which takes U as it is and no scratch."""
    T, B, H2 = ff.shape
    H = H2 // 2
    entry = lib.tpk_ligru_fwd
    stream = [ctypes.c_void_p]
    if not hasattr(lib, "tpk_ligru_fwd_plan"):
        entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + stream
        ptrs, ints = [ff, u, mask], ()
    else:
        plan = lib.tpk_ligru_fwd_plan
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        got = (ctypes.c_int * 5)()
        if plan(B, H, got) != 0:
            raise RuntimeError(f"no cooperative launch at B={B}, H={H}")
        entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + stream
        ptrs, ints = [ff, ligru._pack(u, H, got[1], got[4]), mask], (got[1],)
    entry.restype = ctypes.c_int

    def fn():
        out = torch.empty(T, B, H, device=ff.device)
        scratch = []
        if ints:
            scratch = [torch.zeros((2, -(-B // 8) * 8, -(-H // 4) * 4),
                                   device=ff.device),
                       torch.zeros(1, device=ff.device, dtype=torch.int32)]
        err = entry(*(t.data_ptr() for t in (*ptrs, out, *scratch)), T, B, H,
                    *ints, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return fn


def _inputs(T, B, H, seed):
    """ff, u and a train-style mask on the card."""
    gen = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 2 * H, generator=gen)
    u = torch.randn(H, 2 * H, generator=gen) / H ** 0.5
    mask = (torch.rand(B, H, generator=gen) < 0.8).float()
    return tuple(x.cuda() for x in (ff, u, mask))


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    before = None
    if argv[:1] == ["--before"]:
        before, argv = argv[1], argv[2:]
    shapes: Tuple = (tuple(tuple(int(x) for x in a.split(",")) for a in argv)
                     or SHAPES)
    sources = variants(source(), VARIANTS)
    exact = {name: e for name, (_, e) in VARIANTS.items()}
    if before:
        with open(before) as f:
            sources["before"] = f.read()
        exact["before"] = True
    libs = _build_all(sources, "ligru_fwd")
    bad = 0
    for T, B, H in shapes:
        args = _inputs(T, B, H, T + B)
        plan = ligru.fwd_plan(B, H)
        print(f"T={T} B={B} H={H}: grid P={plan['ctas']} CTAs of u="
              f"{plan['units']} units, {plan['smem_bytes']} shared-memory "
              f"bytes a CTA, {plan['chunk']} columns staged at a time",
              flush=True)
        fns = {name: _runner(lib, *args) for name, lib in libs.items()}
        k2_args = lstm_fwd_phases._inputs(T, B, H, T + B)
        fns["K2f"] = lambda: lstm.lstm_recurrence(*k2_args)
        want = ligru.ligru_recurrence_ref(*args)
        for name, fn in fns.items():
            if not exact.get(name):
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            same = torch.equal(got, again)
            # the one-CTA-per-row design is held to the plain version only
            bad += not (err <= ATOL and (same or name == "before"))
            print(f"T={T} B={B} H={H} {name}: max_abs_err={err:.3e} (atol "
                  f"{ATOL:g}), repeat bitwise equal: {same}", flush=True)
        times = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            times[name].append(median_ms(fns[name]))
        for name, ts in times.items():
            print(f"T={T} B={B} H={H} {name}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms, "
                  f"{1e3 * min(ts) / T:.2f} us per step", flush=True)
        ms = {name: min(ts) for name, ts in times.items()}
        us = {name: 1e3 * v / T for name, v in ms.items()}
        beside = [f"{name} {ms[name]:.3f}" for name in ("before", "K2f")
                  if name in ms]
        print(f"T={T} B={B} H={H} call {ms['as built']:.3f} ms "
              f"({', '.join(beside)}), no steps {ms['no steps']:.3f}; step "
              f"{us['as built'] - us['no steps']:.2f} us: product "
              f"{us['no stream'] - us['neither']:.2f}, stream "
              f"{us['no product'] - us['neither']:.2f}, grid barrier "
              f"{us['neither'] - us['no barriers']:.2f}, cell and the rest "
              f"{us['no barriers'] - us['no steps']:.2f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
