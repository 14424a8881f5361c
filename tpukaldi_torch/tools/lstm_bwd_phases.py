"""K2b's sequential step split by phase, and its three launches, on the card.

    python -m tpukaldi_torch.tools.lstm_bwd_phases [T,B,H ...]

Builds variants of `kernels/csrc/lstm_bwd.cu`, with the remat's header
`lstm_remat.cuh` written into it (`source`), by replacing a line or two
each (`VARIANTS`), and times every variant at each shape (default: the LSTM
recipe's training shapes, the QLSTM's training shape under `qlstm_impl =
scan`, a two-pass batch and the QLSTM's width at 96 rows), in turns,
forward then backward through the list:

- `as built`, and the alternatives `k fastest` (the product's tiles with
  rows k of U fastest across a warp's lanes), `512 threads` (a CTA's,
  then held to 128 registers), `tile 4x8` and `tile 8x4` (a thread's
  product tile, batch rows x rows k of U, against 4 x 4) and `remat 1
  block` (the remat at 153 registers, one block an SM): held to the plain
  version (`lstm_recurrence_bwd_ref`) and to themselves (two calls bitwise
  equal);
- `no product` (no tile of the partial dh product runs), `no exchange`
  (no partial sums are staged or added), `neither`, and `no staging` (the
  product runs, but its sums are not stored to shared memory for the copy
  out): cut phases of the sequential pass, whose outputs are wrong;
- `no chain` (the sequential pass runs no step: the gate remat, dU, the
  U slice's load and the launches) and `remat only` (no chain, no dU).

A step of the chain is (`as built` - `no chain`) / T: its product is `no
exchange` - `neither`, its exchange `no product` - `neither`, and `neither`
- `no chain` is the barrier, the cell and the rest.  The remat is `remat
only`, dU `no chain` - `remat only`.  Prints the card's name and power limit
first; exits 1 if `as built` disagrees with the plain version or between
two calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import List, Tuple

import torch

from ..kernels import _build, lstm
from ..train.chunk_runtime import resolve_device
from .lstm_fwd_phases import _build_all, variants
from .variant_builds import median_ms

SHAPES = ((778, 16, 550), (1000, 16, 550), (778, 32, 1024), (50, 136, 550),
          (50, 96, 1024))
ATOL = 1e-4  # as chip_smoke.py's KERNEL_ATOL on dff and dmask
DU_RTOL = 1e-4  # as chip_smoke.py's DU_RTOL, of max|dU|
_TILES = "        for (int tile = tid; tile < ntile; tile += kThreads) {"
_EXCHANGE = "      const bool exchange = t + 1 < p.T;"
_STEPS = "    for (int t = p.T - 1; t >= 0; --t) {"
_DU = "      tpk::launch_du(h, B, dff, 4 * H, 0, 4 * H, du, T * B, H, stream));"
_NO_PRODUCT = (_TILES, _TILES.replace("tile < ntile", "tile < 0"))
_NO_EXCHANGE = (_EXCHANGE, _EXCHANGE.replace("t + 1 < p.T", "false"))
_NO_CHAIN = (_STEPS, _STEPS.replace("t >= 0", "t >= p.T"))
_NO_DU = (_DU, "      cudaSuccess);")
_MAP = ("            const int tk = tile / tr_n;\n"
        "            const int tr = tile - tk * tr_n;")
_THREADS = "constexpr int kThreads = 256;"
_ROWS = "constexpr int kRows = 4;"
_COLS = "constexpr int kCols = 4;"
_REMAT = "__global__ void __launch_bounds__(kRematThreads, 2)"
_STAGE_OUT = "                if (b < rows) o[b * u] = acc[i][d];"
_INCLUDE = '#include "lstm_remat.cuh"'
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "k fastest": (((_MAP, "            const int tr = tile / kq;\n"
                          "            const int tk = tile - tr * kq;"),), True),
    "512 threads": (((_THREADS, _THREADS.replace("256", "512")),), True),
    "tile 4x8": (((_COLS, _COLS.replace("4;", "8;")),), True),
    "tile 8x4": (((_ROWS, _ROWS.replace("4;", "8;")),), True),
    "remat 1 block": (((_REMAT, _REMAT.replace(", 2)", ")")),), True),
    "no product": ((_NO_PRODUCT,), False),
    "no exchange": ((_NO_EXCHANGE,), False),
    "neither": ((_NO_PRODUCT, _NO_EXCHANGE), False),
    "no staging": (((_STAGE_OUT, _STAGE_OUT.replace(
        "b < rows", "b < rows && acc[i][d] == 1e-30f")),), False),
    "no chain": ((_NO_CHAIN,), False),
    "remat only": ((_NO_CHAIN, _NO_DU), False),
}


def source() -> str:
    """`csrc/lstm_bwd.cu` with `lstm_remat.cuh` written in where it is
    included, so that a variant can replace the remat's lines too."""
    with open(os.path.join(_build._CSRC, lstm.BWD_SOURCE)) as f:
        text = f.read()
    with open(os.path.join(_build._CSRC, "lstm_remat.cuh")) as f:
        header = f.read()
    if text.count(_INCLUDE) != 1:
        raise ValueError(f"{_INCLUDE!r} is not in the source once")
    return text.replace(_INCLUDE, header)


def _runner(lib: ctypes.CDLL, ff, h, c, g, u, mask):
    """fn() -> (dff, du, dmask) through `lib`'s C entry, with the wrapper's
    scratch sized by `lib`'s own plan."""
    T, B, H4 = ff.shape
    H = H4 // 4
    entry = lib.tpk_lstm_bwd
    entry.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    plan = lib.tpk_lstm_bwd_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    plan.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    if plan(B, H, out) != 0:
        raise RuntimeError(f"no cooperative launch at B={B}, H={H}")
    upk = lstm._pack(u, H, torch.float32)
    pbuf = torch.empty(out[4], device=ff.device)

    def fn():
        dff = torch.empty_like(ff)
        du = torch.empty_like(u)
        dmask = torch.empty_like(mask)
        bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
        err = entry(ff.data_ptr(), h.data_ptr(), c.data_ptr(), g.data_ptr(),
                    u.data_ptr(), upk.data_ptr(), mask.data_ptr(),
                    dff.data_ptr(), du.data_ptr(), dmask.data_ptr(),
                    pbuf.data_ptr(), bar.data_ptr(), T, B, H,
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dff, du, dmask
    return fn


def _inputs(T, B, H, seed):
    """ff, u, mask and a gradient of h on the card, and the forward's h and
    c from K2f."""
    gen = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 4 * H, generator=gen)
    u = torch.randn(H, 4 * H, generator=gen) / H ** 0.5
    mask = (torch.rand(B, H, generator=gen) < 0.8).float()
    g = torch.randn(T, B, H, generator=gen) * 0.01
    ff, u, mask, g = ff.cuda(), u.cuda(), mask.cuda(), g.cuda()
    h, c = lstm.lstm_recurrence(ff, u, mask)
    return ff, h, c, g, u, mask


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shapes: Tuple = (tuple(tuple(int(x) for x in a.split(",")) for a in argv)
                     or SHAPES)
    libs = _build_all(variants(source(), VARIANTS), "lstm_bwd")
    bad = 0
    for T, B, H in shapes:
        args = _inputs(T, B, H, T + B)
        plan = lstm.bwd_plan(B, H)
        print(f"T={T} B={B} H={H}: grid P={plan['ctas']} CTAs of u="
              f"{plan['units']} units, {plan['smem_bytes']} shared-memory "
              f"bytes a CTA, {plan['chunk']} producers staged at a time",
              flush=True)
        fns = {name: _runner(lib, *args) for name, lib in libs.items()}
        want = lstm.lstm_recurrence_bwd_ref(*args)
        du_max = want[1].abs().max().item()
        for name, fn in fns.items():
            if not VARIANTS[name][1]:
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            err = {n: (a - b).abs().max().item()
                   for n, a, b in zip(("dff", "du", "dmask"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            bad += not (err["dff"] <= ATOL and err["dmask"] <= ATOL
                        and err["du"] <= DU_RTOL * du_max and same)
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
        print(f"T={T} B={B} H={H} call {ms['as built']:.3f} ms: remat "
              f"{ms['remat only']:.3f}, dU {ms['no chain'] - ms['remat only']:.3f}, "
              f"chain {ms['as built'] - ms['no chain']:.3f}; chain step "
              f"{us['as built'] - us['no chain']:.2f} us: product "
              f"{us['no exchange'] - us['neither']:.2f}, exchange "
              f"{us['no product'] - us['neither']:.2f}, barrier, cell and the "
              f"rest {us['neither'] - us['no chain']:.2f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
