"""K1b's chain step split by phase, and its three launches, on the card.

    python -m tpukaldi_torch.tools.ligru_bwd_phases [--before FILE] [T,B,H ...]

Builds variants of `kernels/csrc/ligru_bwd.cu` by replacing a line or two
each (`VARIANTS`) and times every variant at each shape (default: the
liGRU recipe's training shapes), in turns, forward then backward through
the list:

- `as built`; `rows 8` (tiles of 8 batch rows), `chunk 128`, `chunk 512`
  and `chunk 1024` (units' dA pairs staged at a time, against 256; 1024
  stages the whole row where it fits): the same arithmetic, held to the plain version
  (`ligru_recurrence_bwd_ref`) and to itself (two calls bitwise equal);
- `no product` (the k loop of dA @ U^T runs no step), `no stream` (no
  chunk of dA is staged), `neither`, and `no barriers` (neither, and no
  grid barrier): cut phases of the chain, whose outputs are wrong;
- `no steps` (the chain runs no step: the gate remat, dU, the U slice's
  load and the launches) and `remat only` (no step, no dU);
- with `--before FILE`, `before`: FILE built as it is, a `ligru_bwd.cu`
  of the one-CTA-per-row design (its C entry takes U^T, made here once,
  and no scratch), held to the plain version too;
- `K2b`: the float32 LSTM backward (`lstm.lstm_recurrence_bwd`) at the
  same (T, B, H), on LSTM inputs from the same seed, as a yardstick.

A step of the chain is (`as built` - `no steps`) / T: its product is `no
stream` - `neither`, its stream `no product` - `neither`, its grid barrier
`neither` - `no barriers`, and `no barriers` - `no steps` is the cell, the
loads and stores of dff and the rest.  The remat is `remat only`, dU `no
steps` - `remat only`.  Prints the card's name and power limit first;
exits 1 if a variant with the full arithmetic (or `before`) disagrees
with the plain version, or one of the kernel's own variants between two
calls.
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
from . import lstm_bwd_phases
from .lstm_fwd_phases import _build_all, variants
from .variant_builds import median_ms

SHAPES = ((778, 16, 550), (1000, 16, 550))
ATOL = 1e-4  # as chip_smoke.py's KERNEL_ATOL on dff and dmask
DU_RTOL = 1e-4  # as chip_smoke.py's DU_RTOL, of max|dU|
_K_LOOP = "            for (int kk = s_thr; kk < ksteps; kk += S) {"
_STAGE = "        for (int i = tid; i < mp * per_row; i += kThreads) {"
_ARRIVE = "      if (t > 0) tpk::grid_arrive(p.bar);"
_WAIT = "        tpk::grid_wait(p.bar, arrived);"
_STEPS = "    for (int t = p.T - 1; t >= 0; --t) {"
_DU = "      tpk::launch_du(h, B, dff, 2 * H, 0, 2 * H, du, R, H, stream));"
_NO_PRODUCT = (_K_LOOP, _K_LOOP.replace("kk < ksteps", "kk < 0"))
_NO_STREAM = (_STAGE, _STAGE.replace("i < mp * per_row", "i < 0"))
_NO_BARRIERS = ((_ARRIVE, "      if (t > 0) __syncthreads();"),
                (_WAIT, "        __syncthreads();"))
_NO_STEPS = (_STEPS, _STEPS.replace("t >= 0", "t >= p.T"))
_NO_DU = (_DU, "      cudaSuccess);  // no dU")
_ROWS = "constexpr int kRows = 4;"
_CHUNK = "constexpr int kMaxChunk = 256;"
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "rows 8": (((_ROWS, "constexpr int kRows = 8;"),), True),
    "chunk 128": (((_CHUNK, "constexpr int kMaxChunk = 128;"),), True),
    "chunk 512": (((_CHUNK, "constexpr int kMaxChunk = 512;"),), True),
    "chunk 1024": (((_CHUNK, "constexpr int kMaxChunk = 1024;"),), True),
    "no product": ((_NO_PRODUCT,), False),
    "no stream": ((_NO_STREAM,), False),
    "neither": ((_NO_PRODUCT, _NO_STREAM), False),
    "no barriers": ((_NO_PRODUCT, _NO_STREAM, *_NO_BARRIERS), False),
    "no steps": ((_NO_STEPS,), False),
    "remat only": ((_NO_STEPS, _NO_DU), False),
}


def source() -> str:
    """`csrc/ligru_bwd.cu` as it is."""
    with open(os.path.join(_build._CSRC, ligru.BWD_SOURCE)) as f:
        return f.read()


def _runner(lib: ctypes.CDLL, ff, h, g, u, mask):
    """fn() -> (dff, du, dmask) through `lib`'s C entry, with U packed for
    the units of `lib`'s own plan and the wrapper's scratch sized by it; a
    library without a plan is the one-CTA-per-row design, given U^T
    instead."""
    T, B, H2 = ff.shape
    H = H2 // 2
    entry = lib.tpk_ligru_bwd
    stream = [ctypes.c_void_p]
    if not hasattr(lib, "tpk_ligru_bwd_plan"):
        entry.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + stream
        ptrs, ints, scratch = [ff, h, g, u, u.t().contiguous(), mask], (), 0
    else:
        plan = lib.tpk_ligru_bwd_plan
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        got = (ctypes.c_int * 6)()
        if plan(B, H, got) != 0:
            raise RuntimeError(f"no cooperative launch at B={B}, H={H}")
        entry.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + stream
        ptrs = [ff, h, g, u, ligru._pack_bwd(u, H, got[1], got[4]), mask]
        ints, scratch = (got[1],), got[5]
    entry.restype = ctypes.c_int

    def fn():
        dff = torch.empty_like(ff)
        du = torch.empty_like(u)
        dmask = torch.empty_like(mask)
        extra = []
        if scratch:
            extra = [torch.zeros(scratch, device=ff.device),
                     torch.zeros(1, device=ff.device, dtype=torch.int32)]
        err = entry(*(t.data_ptr() for t in (*ptrs, dff, du, dmask, *extra)),
                    T, B, H, *ints, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dff, du, dmask
    return fn


def _inputs(T, B, H, seed):
    """ff, u, a train-style mask and a gradient of h on the card, and the
    forward's h from K1f."""
    gen = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 2 * H, generator=gen)
    u = torch.randn(H, 2 * H, generator=gen) / H ** 0.5
    mask = (torch.rand(B, H, generator=gen) < 0.8).float()
    g = torch.randn(T, B, H, generator=gen) * 0.01
    ff, u, mask, g = (x.cuda() for x in (ff, u, mask, g))
    h = ligru.ligru_recurrence(ff, u, mask)
    return ff, h, g, u, mask


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
    libs = _build_all(sources, "ligru_bwd")
    bad = 0
    for T, B, H in shapes:
        args = _inputs(T, B, H, T + B)
        plan = ligru.bwd_plan(B, H)
        print(f"T={T} B={B} H={H}: grid P={plan['ctas']} CTAs of u="
              f"{plan['units']} units, {plan['smem_bytes']} shared-memory "
              f"bytes a CTA, {plan['chunk']} units' dA pairs staged at a "
              f"time, {4 * plan['dabuf_floats']} bytes of dA buffer",
              flush=True)
        fns = {name: _runner(lib, *args) for name, lib in libs.items()}
        k2_args = lstm_bwd_phases._inputs(T, B, H, T + B)
        fns["K2b"] = lambda: lstm.lstm_recurrence_bwd(*k2_args)
        want = ligru.ligru_recurrence_bwd_ref(*args)
        du_max = want[1].abs().max().item()
        for name, fn in fns.items():
            if not exact.get(name):
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            err = {n: (a - b).abs().max().item()
                   for n, a, b in zip(("dff", "du", "dmask"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (err["dff"] <= ATOL and err["dmask"] <= ATOL
                  and err["du"] <= DU_RTOL * du_max)
            # the one-CTA-per-row design is held to the plain version only
            bad += not (ok and (same or name == "before"))
            print(f"T={T} B={B} H={H} {name}: max_abs_err dff={err['dff']:.3e} "
                  f"dmask={err['dmask']:.3e} (atol {ATOL:g}), du="
                  f"{err['du']:.3e} of max|du| {du_max:.3f} (rtol "
                  f"{DU_RTOL:g}); repeat bitwise equal: {same}", flush=True)
        times = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            times[name].append(median_ms(fns[name]))
        for name, ts in times.items():
            print(f"T={T} B={B} H={H} {name}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms", flush=True)
        ms = {name: min(ts) for name, ts in times.items()}
        us = {name: 1e3 * v / T for name, v in ms.items()}
        beside = [f"{name} {ms[name]:.3f}" for name in ("before", "K2b")
                  if name in ms]
        print(f"T={T} B={B} H={H} call {ms['as built']:.3f} ms "
              f"({', '.join(beside)}): remat {ms['remat only']:.3f}, dU "
              f"{ms['no steps'] - ms['remat only']:.3f}, chain "
              f"{ms['as built'] - ms['no steps']:.3f}; chain step "
              f"{us['as built'] - us['no steps']:.2f} us: product "
              f"{us['no stream'] - us['neither']:.2f}, stream "
              f"{us['no product'] - us['neither']:.2f}, grid barrier "
              f"{us['neither'] - us['no barriers']:.2f}, cell and the rest "
              f"{us['no barriers'] - us['no steps']:.2f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
