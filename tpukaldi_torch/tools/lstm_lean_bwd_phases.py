"""K4b's sequential step split by phase, and its launches, on the card.

    python -m tpukaldi_torch.tools.lstm_lean_bwd_phases [T,B,H ...]

Builds variants of `kernels/csrc/lstm_lean_bwd.cu` by replacing a line or
two each (`VARIANTS`) and times every variant at each shape (default: the
QLSTM's training shape (778, 32, 1024) and its longest (1000, 32, 1024),
two passes at (50, 136, 1024), and the kernel phase's edges (37, 5, 36) and
(50, 96, 1024)), in turns, forward then backward through the list.  Each
variant's call is the C entry with the wrapper's bf16 operands
(`lean_bwd_operands`), without the dU GEMM:

- `as built`, and the alternatives `R 1` (groups of one CTA: every CTA's
  partial sums over all H rows k, the partial-sum layout of the float32
  backward) and `S 1` (one group: every CTA reads the whole bf16 dA and
  forms complete sums for its own rows k, K4f's broadcast turned around;
  its plan is refused where dA does not fit in shared memory, and the
  tool says so): held to the plain version (`lstm_recurrence_lean_bwd_ref`,
  given the kernel's dff for dU as the wrapper forms it) and to
  themselves (two calls bitwise equal);
- `no product` (no tile of the partial dh product runs, nor its stores),
  `no stores` (the product runs, its partial sums are not stored), `no
  mma` (the product's fragments are loaded and stored, not multiplied),
  `no group barrier` (the group's dA is staged without waiting for it),
  `no exchange` (no partial sums are staged or added), and `neither` (no
  product, no exchange): cut phases of the sequential pass, whose outputs
  are wrong;
- `no chain` (the sequential pass runs no step: the operands, the gate
  remat, the U slice's load and the launches) and `remat only` (the
  operands and the remat, no sequential launch).

Beside them it times the whole wrapper call (`lstm_recurrence_lean_bwd`:
operands, remat, chain and the float32 dU GEMM), the operands alone and
the dU GEMM alone.  A step of the chain is (`as built` - `no chain`) / T:
its product and stores are `no exchange` - `neither` (the stores alone
`as built` - `no stores`, the mma `as built` - `no mma`), its exchange
`no product` - `neither`, its group barrier `as built` - `no group
barrier`, and `neither` - `no chain` is the grid barrier, the dA staging,
the cell and the rest.  The remat is `remat only` - the operands.  Prints
the card's name and power limit first; exits 1 if `as built` disagrees
with the plain version or between two calls.
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

SHAPES = ((778, 32, 1024), (1000, 32, 1024), (50, 136, 1024), (37, 5, 36),
          (50, 96, 1024))
ATOL = 5e-4  # as chip_smoke.py's LEAN_BWD_ATOL on dff and dmask
DU_RTOL = 1e-3  # as chip_smoke.py's LEAN_DU_RTOL, of max|dU|
_TILES = "        for (int nt = warp; nt < ntiles; nt += kWarps) {"
_STORES = "            const int at = mi * 16 * u;"
_MMA = ("              tpk::mma_16816(acc[0], fa, fb[0], fb[2]);\n"
        "              tpk::mma_16816(acc[1], fa, fb[1], fb[3]);")
_GROUP_SYNC = ("        tpk::grid_arrive(gbar);\n"
               "        garrived += R;\n"
               "        tpk::grid_wait(gbar, garrived);\n")
_EXCHANGE = "      const bool exchange = t + 1 < p.T;"
_STEPS = "    for (int t = p.T - 1; t >= 0; --t) {"
_CHAIN = "  return launch_chain(prm, pl, stream);"
_GROUPS = "  for (int R = 1; R <= nu; ++R) {"
_NO_PRODUCT = (_TILES, _TILES.replace("nt < ntiles", "nt < 0"))
# the stores skipped unless two sums are 1e-30 (never), so the product stays
_NO_STORES = (_STORES, _STORES + "\n            if (acc[0][0] != 1e-30f || "
              "acc[1][3] != 1e-30f) continue;")
# the loaded fragments kept alive by a sum of their bits
_NO_MMA = (_MMA, "              acc[0][0] += __uint_as_float(fa[0] ^ fb[0]);\n"
           "              acc[1][0] += __uint_as_float(fa[1] ^ fb[1]);")
_NO_GROUP_SYNC = (_GROUP_SYNC, "")
_NO_EXCHANGE = (_EXCHANGE, _EXCHANGE.replace("t + 1 < p.T", "false"))
_NO_CHAIN = (_STEPS, _STEPS.replace("t >= 0", "t >= p.T"))
_NO_SEQ = (_CHAIN, "  return 0;  // the remat alone")
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "R 1": (((_GROUPS, _GROUPS.replace("R <= nu", "R <= 1")),), True),
    "S 1": (((_GROUPS, _GROUPS.replace("R = 1; R <= nu", "R = nu; R <= nu")),),
            True),
    "no product": ((_NO_PRODUCT,), False),
    "no stores": ((_NO_STORES,), False),
    "no mma": ((_NO_MMA,), False),
    "no group barrier": ((_NO_GROUP_SYNC,), False),
    "no exchange": ((_NO_EXCHANGE,), False),
    "neither": ((_NO_PRODUCT, _NO_EXCHANGE), False),
    "no chain": ((_NO_CHAIN,), False),
    "remat only": ((_NO_SEQ,), False),
}


def source() -> str:
    with open(os.path.join(_build._CSRC, lstm.LEAN_BWD_SOURCE)) as f:
        return f.read()


def _runner(lib: ctypes.CDLL, ff, h, c, g, u, mask):
    """fn() -> (dff, dmask) through `lib`'s C entry, with the wrapper's
    operands and scratch sized by `lib`'s own plan."""
    T, B, H4 = ff.shape
    H = H4 // 4
    entry = lib.tpk_lstm_lean_bwd
    entry.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    plan = lib.tpk_lstm_lean_bwd_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    plan.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    if plan(B, H, out) != 0:
        raise RuntimeError(f"no cooperative launch at B={B}, H={H}")
    pbuf = torch.empty(out[4], device=ff.device)
    dabuf = torch.zeros(out[7], device=ff.device, dtype=torch.bfloat16)

    def fn():
        ops = lstm.lean_bwd_operands(h, u)
        dff = torch.empty_like(ff)
        dmask = torch.empty_like(mask)
        bar = torch.zeros(1 + out[5], device=ff.device, dtype=torch.int32)
        err = entry(ff.data_ptr(), c.data_ptr(), g.data_ptr(),
                    *(o.data_ptr() for o in ops), mask.data_ptr(),
                    dff.data_ptr(), dmask.data_ptr(), pbuf.data_ptr(),
                    dabuf.data_ptr(), bar.data_ptr(), T, B, H,
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return dff, dmask
    return fn


def _inputs(T, B, H, seed):
    """ff, u, mask and a gradient of h on the card, and the forward's h and
    c from K4f."""
    gen = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 4 * H, generator=gen)
    u = torch.randn(H, 4 * H, generator=gen) / H ** 0.5
    mask = (torch.rand(B, H, generator=gen) < 0.8).float()
    g = torch.randn(T, B, H, generator=gen) * 0.01
    ff, u, mask, g = ff.cuda(), u.cuda(), mask.cuda(), g.cuda()
    h, c = lstm.lstm_recurrence_lean(ff, u, mask)
    return ff, h, c, g, u, mask


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shapes: Tuple = (tuple(tuple(int(x) for x in a.split(",")) for a in argv)
                     or SHAPES)
    libs = _build_all(variants(source(), VARIANTS), "lstm_lean_bwd")
    bad = 0
    for T, B, H in shapes:
        args = _inputs(T, B, H, T + B)
        ff, h, c, g, u, mask = args
        plan = lstm.lean_bwd_plan(B, H)
        print(f"T={T} B={B} H={H}: grid P={plan['ctas']} CTAs of u="
              f"{plan['units']} units in {plan['groups']} groups of "
              f"{plan['group_ctas']}, {plan['smem_bytes']} shared-memory "
              f"bytes a CTA, {plan['chunk']} groups' partial sums staged at "
              f"a time, {4 * plan['pbuf_floats']} bytes of partial-sum "
              f"buffer", flush=True)
        fns = {}
        for name, lib in libs.items():
            try:
                fns[name] = _runner(lib, *args)
            except RuntimeError as e:  # a plan the card cannot hold
                print(f"T={T} B={B} H={H} {name}: {e}", flush=True)
        want = lstm.lstm_recurrence_lean_bwd_ref(*args)
        du_max = want[1].abs().max().item()
        for name, fn in fns.items():
            if not VARIANTS[name][1]:
                continue
            got, again = fn(), fn()
            du = h[:-1].reshape(-1, H).t() @ got[0][1:].reshape(-1, 4 * H)
            torch.cuda.synchronize()
            err = {"dff": (got[0] - want[0]).abs().max().item(),
                   "dmask": (got[1] - want[2]).abs().max().item(),
                   "du": (du - want[1]).abs().max().item()}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            bad += not (err["dff"] <= ATOL and err["dmask"] <= ATOL
                        and err["du"] <= DU_RTOL * du_max and same)
            print(f"T={T} B={B} H={H} {name}: max_abs_err dff={err['dff']:.3e} "
                  f"dmask={err['dmask']:.3e} (atol {ATOL:g}), du="
                  f"{err['du']:.3e} of max|du| {du_max:.3f} (rtol "
                  f"{DU_RTOL:g}); repeat bitwise equal: {same}", flush=True)
        dff = fns["as built"]()[0]
        extra = {
            "call": lambda: lstm.lstm_recurrence_lean_bwd(*args),
            "operands": lambda: lstm.lean_bwd_operands(h, u),
            "dU GEMM": lambda: h[:-1].reshape(-1, H).t() @ dff[1:].reshape(-1, 4 * H),
        }
        fns.update(extra)
        times = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            times[name].append(median_ms(fns[name]))
        for name, ts in times.items():
            print(f"T={T} B={B} H={H} {name}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms", flush=True)
        ms = {name: min(ts) for name, ts in times.items()}
        us = {name: 1e3 * v / T for name, v in ms.items()}
        print(f"T={T} B={B} H={H} call {ms['call']:.3f} ms: operands "
              f"{ms['operands']:.3f}, remat {ms['remat only'] - ms['operands']:.3f}, "
              f"chain launch and U load {ms['no chain'] - ms['remat only']:.3f}, "
              f"chain {ms['as built'] - ms['no chain']:.3f}, dU GEMM "
              f"{ms['dU GEMM']:.3f}; chain step "
              f"{us['as built'] - us['no chain']:.2f} us: product and its "
              f"stores {us['no exchange'] - us['neither']:.2f} (the stores "
              f"{us['as built'] - us['no stores']:.2f}, the mma "
              f"{us['as built'] - us['no mma']:.2f}), exchange "
              f"{us['no product'] - us['neither']:.2f}, group barrier "
              f"{us['as built'] - us['no group barrier']:.2f}, barriers, dA, "
              f"cell and the rest {us['neither'] - us['no chain']:.2f}",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
