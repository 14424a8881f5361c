"""K3b's chain step split by phase, and its launches, on the card.

    python -m tpukaldi_torch.tools.gru_bwd_phases [--before FILE] [T,B,H ...]

Builds variants of `kernels/csrc/gru_bwd.cu` by replacing a line or two
each (`VARIANTS`) and times every variant at each shape (default: the GRU
recipe's training shapes), in turns, forward then backward through the
list, at the recipe's activation (tanh):

- `as built`: held to the plain version (`gru_recurrence_bwd_ref`) and to
  itself (two calls bitwise equal);
- `no product` (no tile of either partial-sum product runs), `no exchange`
  (no partial sums are staged or added, in either exchange), `neither`,
  and `no barriers` (neither, and no grid barrier): cut phases of the
  chain, whose outputs are wrong;
- `no chain` (the chain runs no step: the gate remat, dU, the U slices'
  load and the launches) and `remat only` (no chain, no dU);
- with `--before FILE`, `before`: FILE built as it is, a `gru_bwd.cu` of
  the one-CTA-per-row design (its C entry takes Uh^T and Uzr^T, made here
  once), held to the plain version too;
- `K2b`: the float32 LSTM backward (`lstm.lstm_recurrence_bwd`) at the
  same (T, B, H), on LSTM inputs from the same seed, as a yardstick.

A step of the chain is (`as built` - `no chain`) / T: its products are `no
exchange` - `neither`, its exchanges `no product` - `neither`, its two
grid barriers `neither` - `no barriers`, and `no barriers` - `no chain` is
the cell and the rest.  The remat is `remat only`, dU `no chain` - `remat
only`.  Prints the card's name and power limit first; exits 1 if `as
built` (or `before`) disagrees with the plain version, or `as built`
between two calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import List, Tuple

import torch

from ..kernels import _build, gru, lstm
from ..train.chunk_runtime import resolve_device
from . import lstm_bwd_phases
from .lstm_fwd_phases import _build_all, variants
from .variant_builds import median_ms

SHAPES = ((778, 16, 550), (1000, 16, 550))
ACT = "tanh"  # the GRU recipe's activation
ATOL = 1e-4  # as chip_smoke.py's KERNEL_ATOL on dff and dmask
DU_RTOL = 1e-4  # as chip_smoke.py's DU_RTOL, of max|dU|
_TILES = "        for (int tile = tid; tile < ntile; tile += kThreads) {"
_EXCHANGE_B = "      const bool exchange = t + 1 < p.T;"
_EXCHANGE_A = ("      stage(pA + static_cast<size_t>(me) * P * blk, 0);\n"
               "      gather(pA + static_cast<size_t>(me) * P * blk, drh);")
_STEPS = "    for (int t = p.T - 1; t >= 0; --t) {"
_DU = ("  err = static_cast<int>(\n"
       "      tpk::launch_du(h, B, dff, 3 * H, H, 2 * H, duzr, T * B, H, stream));\n"
       "  if (err != 0) return err;\n"
       "  return static_cast<int>(\n"
       "      tpk::launch_du(rh_scratch, 0, dff, 3 * H, 0, H, duh, T * B, H, stream));")
_NO_PRODUCT = (_TILES, _TILES.replace("tile < ntile", "tile < 0"))
_NO_EXCHANGE = ((_EXCHANGE_B, _EXCHANGE_B.replace("t + 1 < p.T", "false")),
                (_EXCHANGE_A, "      // no exchange"))
_NO_BARRIERS = (
    ("      tpk::grid_arrive(p.bar);\n      arrived += gridDim.x;\n"
     "      tpk::grid_wait(p.bar, arrived);",
     "      __syncthreads();"),)
_NO_CHAIN = (_STEPS, _STEPS.replace("t >= 0", "t >= p.T"))
_NO_DU = (_DU, "  return 0;  // no dU")
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "no product": ((_NO_PRODUCT,), False),
    "no exchange": (_NO_EXCHANGE, False),
    "neither": ((_NO_PRODUCT, *_NO_EXCHANGE), False),
    "no barriers": ((_NO_PRODUCT, *_NO_EXCHANGE, *_NO_BARRIERS), False),
    "no chain": ((_NO_CHAIN,), False),
    "remat only": ((_NO_CHAIN, _NO_DU), False),
}


def source() -> str:
    """`csrc/gru_bwd.cu` as it is."""
    with open(os.path.join(_build._CSRC, gru.BWD_SOURCE)) as f:
        return f.read()


def _runner(lib: ctypes.CDLL, ff, h, g, uzr, uh, mask, act=ACT):
    """fn() -> (dff, duzr, duh, dmask) through `lib`'s C entry, with the
    wrapper's scratch sized by `lib`'s own plan; a library without a plan
    is the one-CTA-per-row design, given the transposes instead."""
    T, B, H3 = ff.shape
    H = H3 // 3
    entry = lib.tpk_gru_bwd
    persistent = hasattr(lib, "tpk_gru_bwd_plan")
    entry.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    if persistent:
        plan = lib.tpk_gru_bwd_plan
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
        out = (ctypes.c_int * 5)()
        if plan(B, H, out) != 0:
            raise RuntimeError(f"no cooperative launch at B={B}, H={H}")
        pbuf = torch.empty(out[4], device=ff.device)
    else:
        uht, uzrt = uh.t().contiguous(), uzr.t().contiguous()

    def fn():
        dff = torch.empty_like(ff)
        duzr = torch.empty_like(uzr)
        duh = torch.empty_like(uh)
        dmask = torch.empty_like(mask)
        rh = torch.empty_like(h)
        if persistent:
            bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
            ptrs = (ff, h, g, uzr, uh, mask, dff, duzr, duh, dmask, rh, pbuf,
                    bar)
        else:
            ptrs = (ff, h, g, uzr, uh, uht, uzrt, mask, dff, duzr, duh, dmask,
                    rh)
        err = entry(*(t.data_ptr() for t in ptrs), T, B, H,
                    gru.ACTS.index(act),
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dff, duzr, duh, dmask
    return fn


def _inputs(T, B, H, seed):
    """ff, uzr, uh, mask and a gradient of h on the card, and the forward's
    h from K3f."""
    gen = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 3 * H, generator=gen)
    uzr = torch.randn(H, 2 * H, generator=gen) / H ** 0.5
    uh = torch.randn(H, H, generator=gen) / H ** 0.5
    mask = (torch.rand(B, H, generator=gen) < 0.8).float()
    g = torch.randn(T, B, H, generator=gen) * 0.01
    ff, uzr, uh, mask, g = (x.cuda() for x in (ff, uzr, uh, mask, g))
    h = gru.gru_recurrence(ff, uzr, uh, mask, ACT)
    return ff, h, g, uzr, uh, mask


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
    libs = _build_all(sources, "gru_bwd")
    bad = 0
    for T, B, H in shapes:
        args = _inputs(T, B, H, T + B)
        plan = gru.bwd_plan(B, H)
        print(f"T={T} B={B} H={H}: grid P={plan['ctas']} CTAs of u="
              f"{plan['units']} units, {plan['smem_bytes']} shared-memory "
              f"bytes a CTA, {plan['chunk']} producers staged at a time, "
              f"{4 * plan['pbuf_floats']} bytes of partial-sum buffers",
              flush=True)
        fns = {name: _runner(lib, *args) for name, lib in libs.items()}
        k2_args = lstm_bwd_phases._inputs(T, B, H, T + B)
        fns["K2b"] = lambda: lstm.lstm_recurrence_bwd(*k2_args)
        want = gru.gru_recurrence_bwd_ref(*args, ACT)
        du_max = [w.abs().max().item() for w in want[1:3]]
        for name, fn in fns.items():
            if not exact.get(name):
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            err = [(a - b).abs().max().item() for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (err[0] <= ATOL and err[3] <= ATOL
                  and all(e <= DU_RTOL * m for e, m in zip(err[1:3], du_max)))
            # the one-CTA-per-row design is held to the plain version only
            bad += not (ok and (same or name == "before"))
            print(f"T={T} B={B} H={H} {name}: max_abs_err dff={err[0]:.3e} "
                  f"dmask={err[3]:.3e} (atol {ATOL:g}), duzr={err[1]:.3e} of "
                  f"{du_max[0]:.3f}, duh={err[2]:.3e} of {du_max[1]:.3f} "
                  f"(rtol {DU_RTOL:g}); repeat bitwise equal: {same}",
                  flush=True)
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
              f"{ms['no chain'] - ms['remat only']:.3f}, chain "
              f"{ms['as built'] - ms['no chain']:.3f}; chain step "
              f"{us['as built'] - us['no chain']:.2f} us: products "
              f"{us['no exchange'] - us['neither']:.2f}, exchanges "
              f"{us['no product'] - us['neither']:.2f}, two grid barriers "
              f"{us['neither'] - us['no barriers']:.2f}, cell and the rest "
              f"{us['no barriers'] - us['no chain']:.2f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
