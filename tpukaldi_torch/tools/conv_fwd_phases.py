"""K5f's and K6f's tilings and phases timed, and their outputs held bitwise
to another build's, on the card.

    python -m tpukaldi_torch.tools.conv_fwd_phases [--before DIR ...] [N,L,K,O,pool ...]

Builds variants of `kernels/csrc/conv_pool_fwd.cu` (K5f) and
`conv_ln_fwd.cu` (K6f) with their headers `conv_fwd.cuh`, `conv_tile.cuh`
and `persist_grid.cuh`, each variant replacing a line or a few across the
files (`VARIANTS`), and at each shape (default: the raw recipes' training
batch, 128 windows of 3200 samples, K = 129, pool 3, at O = 80, SincNet's
layer 0, and O = 128, CNN's) times K5f (with idx) and K6f (at dropout
0.15, CNN_raw's, with its residuals) in turns, forward then backward
through the list:

- `as built`; the tilings `P 24 F 2` (conv positions by filters a conv
  thread computes, against 12 by 4: the same chains, half the weight loads
  a fmaf) and `F 2` (12 by 2), `filters 32` (filters a block, against
  16); the long block's warps (conv + epilogue) `K5f warps 8 + 8` (against
  12 + 4), `K6f warps 12 + 4` and `K6f warps 8 + 4` (against 8 + 8); the
  block a window goes to, `long block only` and `short block only`
  (against the short block for a window whose runs fill less than one
  conv pass of the long, `conv_fwd.cuh::fwd_short`) and `K6f short 4 + 4`
  (the short block's warps, against 2 + 2); `balanced grid` (the fewest
  blocks that keep the most items a block walks, against all the card
  holds); `one buffer` (conv and
  epilogue take turns, against overlapping), `not persistent` (a block an
  item, against a grid the card holds at once walking items) and `plain
  stage` (the window loaded word by word, not by cp.async): the same
  chains, held bitwise to `as built`;
- `conv only` and `epilogue only`: the epilogue cut (K5f's write-out, K6f's
  layer norm and write-out), or the conv cut (their outputs are wrong):
  each side of the pipeline timed alone;
- with `--before DIR` (given once or more), `before` (then `before 2`,
  ...): DIR's two sources and headers built as they are (e.g. the
  parent commit's `csrc`, from `git archive <parent>
  tpukaldi_torch/kernels/csrc` unpacked under `build/`), every output held
  bitwise (`torch.equal`) to `as built`'s at every shape, at `EQUAL_SHAPES`
  (chip_smoke.py's odd and CNN_fbank shapes, and the launch's other paths:
  K6f's one pooled-row buffer and K5f's row blocks, with rows whose start
  is not 16-byte aligned; drop 0 and 0.15, relu on and off; K6f only where
  a window fits a block) and at the 32,000-window serving batch (K5f at
  O = 80 without idx, K6f at O = 128 without residuals, both timed there
  too); then K5f and K6f through the port's wrappers with each build's
  libraries, at `WRAPPED`, each call timed alone (the host's share
  included, as chip_smoke.py times them) and on the device alone.

Each timing is a call alone, the median of 5 between two events (the
host's share of a call included), and a call on the device alone, 20
calls queued behind a sleep of the card (`_queued_ms`), forward then
backward through the builds.  Prints the card's name and power limit
first, then ptxas's registers and each build's launch (`conv1d.fwd_plan`);
exits 1 if a build with the full
arithmetic disagrees with the plain version (CONV_ATOL) or is not bitwise
`as built`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from ..kernels import _build, conv1d
from ..train.chunk_runtime import resolve_device
from .conv_bwd_phases import _cut, _set, variant_files
from . import variant_builds
from .variant_builds import median_ms

SHAPES = ((128, 3200, 129, 80, 3), (128, 3200, 129, 128, 3))
# chip_smoke.py's CONV_ODD and CONV_FBANK, then a window with one
# pooled-row buffer (K6f) and one in row blocks, the last one short (K5f;
# K6f refuses it), odd L so the second row's start is not 16-byte aligned:
# held bitwise but not timed
EQUAL_SHAPES = ((13, 701, 100, 7, 3), (128, 440, 10, 80, 3),
                (2, 4501, 129, 20, 3), (2, 20001, 129, 16, 1))
SERVE = (32000, 3200, 129, 3)  # chip_smoke.py's serving batch
# timed through the port's wrappers with each build's library: CNN_fbank's
# layer 0 (chip_smoke.py's CONV_FBANK), then the training batch at O = 80
# and 128
WRAPPED = ((128, 440, 10, 80, 3), (128, 3200, 129, 80, 3),
           (128, 3200, 129, 128, 3))
DROP = 0.15  # CNN_raw's layer-0 dropout
EPS, SEED = 1e-6, -12345
CONV_ATOL = 1e-5  # chip_smoke.py's, kernel against plain version
FILES = ("conv_pool_fwd.cu", "conv_ln_fwd.cu", "conv_fwd.cuh",
         "conv_tile.cuh", "persist_grid.cuh")
_EPI = ("      epi(it, m0, min(g.rows, M - m0), ys + (j % g.nbuf) * ysz,")
_CONV = "        conv_pool_runs<W>(xs + (j & 1) * g.span, ws + (j & 1) * wsz,"
_STAGE = "  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {"
_K5_WARPS = "using Warps = tpk::FwdWarps<12, 4>;"  # conv, epilogue warps
_K6_WARPS = "using Warps = tpk::FwdWarps<8, 8>;"
_K6_SHORT = "using Short = tpk::FwdWarps<2, 2>;"
_SHORT = "  return (M + fwd_rows(pool) - 1) / fwd_rows(pool) < W::kRuns;"
_GRID = "  return kPersistent ? min(g.items, sms * *per_sm) : g.items;"
# the fewest blocks that keep the most items a block walks
_BALANCED = ("  const int most = (g.items + sms * *per_sm - 1) / (sms * *per_sm);\n"
             "  return (g.items + most - 1) / most;")

# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "P 24 F 2": ((_set("int kFwdRun", "12", "24"),
                  _set("int kTileF", "4", "2")), True),
    "F 2": ((_set("int kTileF", "4", "2"),), True),
    "filters 32": ((_set("int kFwdFilt", "16", "32"),), True),
    "K5f warps 8 + 8": (((_K5_WARPS, _K5_WARPS.replace("12, 4", "8, 8")),),
                        True),
    "K6f warps 12 + 4": (((_K6_WARPS, _K6_WARPS.replace("8, 8", "12, 4")),),
                         True),
    "K6f warps 8 + 4": (((_K6_WARPS, _K6_WARPS.replace("8, 8", "8, 4")),),
                        True),
    "long block only": (((_SHORT, "  return false;"),), True),
    "short block only": (((_SHORT, "  return true;"),), True),
    "K6f short 4 + 4": (((_K6_SHORT, _K6_SHORT.replace("2, 2", "4, 4")),),
                        True),
    "balanced grid": (((_GRID, _BALANCED),), True),
    "one buffer": ((_set("int kMaxBufs", "2", "1"),), True),
    "not persistent": ((_set("bool kPersistent", "true", "false"),), True),
    "plain stage": (((_STAGE, "  if (false) {"),), True),
    "conv only": ((_cut(_EPI),), False),
    "epilogue only": ((_cut(_CONV),), False),
}


def sources(src_dir: str = _build._CSRC) -> Dict[str, str]:
    """The files as they are in `src_dir` (a design before conv_fwd.cuh
    has none)."""
    return variant_builds.sources(src_dir, FILES)


def _plans(name: str, libs: Dict[str, ctypes.CDLL], shape) -> str:
    """Each kernel's launch at `shape`, where the build has a plan entry
    (`conv1d.fwd_plan`) and a window fits K6f's block."""
    N, L, K, O, pool = shape
    parts = [f"{kern} {conv1d.fwd_plan(src, *shape, lib=libs[src])}"
             for kern, src in (("K5f", conv1d.SOURCE), ("K6f", conv1d.LN_SOURCE))
             if hasattr(libs[src], f"tpk_{src[:-3]}_plan")
             and (kern == "K5f" or _k6_fits(libs[src], L, K, pool))]
    return f"{name} plan N={N} L={L} K={K} O={O} pool={pool}: " + "; ".join(
        parts)


def _runners(libs: Dict[str, ctypes.CDLL], x, w, bias, gt, bt, pool):
    """(k5f(need_idx), k6f(drop, relu, residuals)) -> their outputs,
    through the build's C entries."""
    N, L = x.shape
    K, O = w.shape
    M = (L - K + 1) // pool
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    stream = torch.cuda.current_stream().cuda_stream
    k5 = libs["conv_pool_fwd.cu"].tpk_conv_pool_fwd
    k5.argtypes = [P] * 4 + [I] * 5 + [P]
    k6 = libs["conv_ln_fwd.cu"].tpk_conv_ln_fwd
    k6.argtypes = [P] * 10 + [I] * 5 + [F, I, U, F, I, P]
    seed_t = conv1d._seed_tensor(SEED, x.device)
    ptr = conv1d._ptr

    def k5f(need_idx=True):
        y = torch.empty((N, M, O), device=x.device)
        idx = (torch.empty((N, M, O), device=x.device, dtype=torch.int8)
               if need_idx else None)
        err = k5(x.data_ptr(), w.data_ptr(), y.data_ptr(), ptr(idx), N, L, K,
                 O, pool, stream)
        if err != 0:
            raise RuntimeError(f"K5f launch failed with CUDA error {err}")
        return y, idx

    def k6f(drop=DROP, relu=True, residuals=True):
        out = torch.empty((N, M, O), device=x.device)
        idx = stats = ypool = None
        if residuals:
            idx = torch.empty((N, M, O), device=x.device, dtype=torch.int8)
            stats = torch.empty((N, 2, O), device=x.device)
            ypool = torch.empty_like(out)
        threshold, scale, on = conv1d._drop_args(drop)
        err = k6(x.data_ptr(), w.data_ptr(), bias.data_ptr(), gt.data_ptr(),
                 bt.data_ptr(), seed_t.data_ptr(), out.data_ptr(), ptr(idx),
                 ptr(stats), ptr(ypool), N, L, K, O, pool, EPS, int(relu),
                 threshold, scale, on, stream)
        if err != 0:
            raise RuntimeError(f"K6f launch failed with CUDA error {err}")
        return out, idx, stats, ypool
    return k5f, k6f


def _inputs(N, L, K, O, pool, seed):
    """x, w, bias, gt and bt on the card, as chip_smoke.py's conv phase
    draws them."""
    g = torch.Generator().manual_seed(seed)
    M = (L - K + 1) // pool
    x = torch.randn(N, L, generator=g)
    w = torch.randn(K, O, generator=g) / K ** 0.5
    bias = torch.randn(O, generator=g)
    gt = 1 + 0.3 * torch.randn(M, O, generator=g)
    bt = 0.3 * torch.randn(M, O, generator=g)
    return [t.cuda() for t in (x, w, bias, gt, bt)]


# the calls whose outputs are held: K5f with and without idx, K6f at drop
# 0 and DROP, relu on and off, with and without residuals
_CALLS = (("K5f", (True,)), ("K5f", (False,)),
          ("K6f", (0.0, True, True)), ("K6f", (DROP, True, True)),
          ("K6f", (0.0, False, True)), ("K6f", (DROP, True, False)))


def _same(a, b) -> bool:
    return all((u is None and v is None) or (u is not None and v is not None
                                             and torch.equal(u, v))
               for u, v in zip(a, b))


def _k6_fits(lib: ctypes.CDLL, L: int, K: int, pool: int) -> bool:
    """Whether a window of L samples fits a K6f block of the build."""
    fn = lib.tpk_conv_ln_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_long
    return fn(L, K, pool) <= conv1d.SMEM_LIMIT


def _check(libs, exact, shape, seed) -> int:
    """Every exact build's outputs at `shape` against the plain version
    and bitwise against `as built`'s (K6f in the builds where a window
    fits a block, named where it does not); prints a line each; returns
    the count of failures."""
    N, L, K, O, pool = shape
    tag = f"N={N} L={L} K={K} O={O} pool={pool}"
    fits = {name: _k6_fits(lib["conv_ln_fwd.cu"], L, K, pool)
            for name, lib in libs.items() if exact[name]}
    k6 = fits["as built"]
    x, w, bias, gt, bt = _inputs(*shape, seed)
    runs = {name: _runners(lib, x, w, bias, gt, bt, pool)
            for name, lib in libs.items() if exact[name]}
    bad = 0
    with torch.inference_mode():
        y_r = conv1d.conv1d_pool_ref(x, w, pool)[0]
        z_r = {(drop, relu): conv1d.conv1d_pool_ln_act_ref(
            x, w, bias, gt, bt, SEED, pool, EPS, relu, drop)[0]
            for drop, relu in ((0.0, True), (DROP, True), (0.0, False))
            if k6}
        for kern, args in _CALLS:
            if kern == "K6f" and not k6:
                continue
            fns = {name: r[0 if kern == "K5f" else 1]
                   for name, r in runs.items() if kern == "K5f" or fits[name]}
            refused = [name for name in runs if name not in fns]
            want = fns["as built"](*args)
            plain = y_r if kern == "K5f" else z_r[args[:2]]
            err = (want[0] - plain).abs().max().item()
            same = {name: _same(fn(*args), want)
                    for name, fn in fns.items() if name != "as built"}
            torch.cuda.synchronize()
            ok = err <= CONV_ATOL and all(same.values())
            bad += not ok
            differ = [name for name, s in same.items() if not s]
            print(f"{tag} {kern}{args}: as built max_abs_err={err:.3e} (atol "
                  f"{CONV_ATOL:g}); every output bitwise as built in "
                  f"{len(same) - len(differ)} of {len(same)} builds"
                  + (f", NOT in {', '.join(differ)}" if differ else "")
                  + (f"; refused (shared memory) by {', '.join(refused)}"
                     if refused else ""), flush=True)
            del want
    return bad


def _queued_ms(fn, n: int = 20) -> float:
    """The device's ms a call of fn: n calls queued behind a sleep of the
    card long enough for the host to launch them all, between two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the card's ~2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _wrapped(libs, names) -> None:
    """K5f (with idx) and K6f (drop 0.15, with residuals) through the
    port's wrappers, `conv1d.conv1d_pool` and `conv1d.conv1d_pool_ln_act`,
    with each build's libraries in turn (as built and each `before`), at
    WRAPPED: the median of 21 calls, each timed alone as chip_smoke.py
    times them (the host's share included, K6f's seed an int the wrapper
    copies to the card), and the device's time a call (`_queued_ms`, the
    seed a tensor on the card as the recipes pass it: an int's copy would
    wait for the queue)."""
    loaded = dict(_build._loaded)
    try:
        for shape in WRAPPED:
            N, L, K, O, pool = shape
            x, w, bias, gt, bt = _inputs(*shape, N + O)
            seed_t = conv1d._seed_tensor(SEED, x.device)
            calls = {"K5f": (lambda: conv1d.conv1d_pool(x, w, pool),) * 2,
                     "K6f": tuple(lambda s=s: conv1d.conv1d_pool_ln_act(
                         x, w, bias, gt, bt, s, pool, EPS, True, DROP)
                                  for s in (SEED, seed_t))}
            times: Dict = {}
            with torch.inference_mode():
                for name in names + names[::-1]:
                    _build._loaded[conv1d.SOURCE] = libs[name][conv1d.SOURCE]
                    _build._loaded[conv1d.LN_SOURCE] = libs[name][
                        conv1d.LN_SOURCE]
                    for kern, (alone, queued) in calls.items():
                        times.setdefault(kern, {}).setdefault(name, []).append(
                            (median_ms(alone, 21), _queued_ms(queued)))
            for kern, by in times.items():
                print(f"through the wrapper N={N} L={L} K={K} O={O} "
                      f"pool={pool} {kern}: " + "; ".join(
                          f"{name} " + " / ".join(f"{a:.3f}" for a, _ in ts)
                          + " ms a call alone, " + " / ".join(
                              f"{d:.4f}" for _, d in ts) + " ms on the device"
                          for name, ts in by.items()), flush=True)
            del x, calls
    finally:
        _build._loaded.clear()
        _build._loaded.update(loaded)


def _serve(libs, befores) -> int:
    """K5f (O = 80, no idx) and K6f (O = 128, no residuals) at the serving
    batch: as built and each `before`, timed in turns, outputs bitwise."""
    N, L, K, pool = SERVE
    bad = 0
    for kern, O in (("K5f", 80), ("K6f", 128)):
        x, w, bias, gt, bt = _inputs(1, L, K, O, pool, O)
        x = torch.randn(N, L, device="cuda")
        names = ["as built", *befores]
        fns = {}
        for name in names:
            k5f, k6f = _runners(libs[name], x, w, bias, gt, bt, pool)
            fns[name] = ((lambda f=k5f: f(False)[0]) if kern == "K5f" else
                         (lambda f=k6f: f(0.0, True, False)[0]))
        with torch.inference_mode():
            want = fns["as built"]()
            for name in befores:
                same = torch.equal(fns[name](), want)
                bad += not same
                print(f"serving N={N} {kern} O={O}: {name} bitwise as built: "
                      f"{same}", flush=True)
            del want
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(median_ms(fns[name], 3))
        print(f"serving N={N} L={L} K={K} O={O} pool={pool} {kern}: "
              + "; ".join(f"{name} " + " / ".join(f"{t:.3f}" for t in ts)
                          + " ms" for name, ts in times.items()), flush=True)
        del x
        torch.cuda.empty_cache()
    return bad


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    befores = []
    while argv[:1] == ["--before"]:
        befores.append(argv[1])
        argv = argv[2:]
    shapes: Tuple = (tuple(tuple(int(v) for v in a.split(",")) for a in argv)
                     or SHAPES)
    files = variant_files(sources(), VARIANTS)
    exact = {name: e for name, (_, e) in VARIANTS.items()}
    names = []
    for i, d in enumerate(befores):
        name = "before" + (f" {i + 1}" if i else "")
        files[name] = sources(d)
        exact[name] = True
        names.append(name)
    libs = variant_builds.build_variants(files, "conv_fwd", FILES[:2])
    for name, lib in libs.items():
        print(_plans(name, lib, shapes[0]), flush=True)
    for shape in shapes[1:] + (EQUAL_SHAPES if befores else ()):
        print(_plans("as built", libs["as built"], shape), flush=True)
    bad = 0
    for shape in shapes:
        N, L, K, O, pool = shape
        tag = f"N={N} L={L} K={K} O={O} pool={pool}"
        bad += _check(libs, exact, shape, N + O)
        x, w, bias, gt, bt = _inputs(*shape, N + O)
        fns = {}
        for name, lib in libs.items():
            k5f, k6f = _runners(lib, x, w, bias, gt, bt, pool)
            fns[name, "K5f"] = k5f
            fns[name, "K6f"] = k6f
        times: Dict = {key: [] for key in fns}
        device: Dict = {key: [] for key in fns}
        for key in list(fns) + list(reversed(fns)):
            times[key].append(median_ms(fns[key]))
            device[key].append(_queued_ms(fns[key]))
        for (name, kern), ts in times.items():
            print(f"{tag} {name} {kern}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms a call alone, "
                  f"{' / '.join(f'{t:.4f}' for t in device[name, kern])} ms "
                  f"on the device", flush=True)
        for what, by in (("alone", times), ("on the device", device)):
            ms = {key: min(ts) for key, ts in by.items()}
            for kern in ("K5f", "K6f"):
                parts = ", ".join(f"{name} {ms[name, kern]:.4f}"
                                  for name in libs if name != "as built")
                print(f"{tag} {kern} {what}: as built "
                      f"{ms['as built', kern]:.4f} ms; {parts}", flush=True)
        del fns, x
    for shape in EQUAL_SHAPES if befores else ():
        bad += _check(libs, exact, shape, shape[0] + shape[3])
    if befores:
        bad += _serve(libs, names)
        _wrapped(libs, ["as built", *names])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
