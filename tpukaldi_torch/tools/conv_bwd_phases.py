"""K5b's and K6b's launches timed alone, and the dX pass's tilings, on the
card.

    python -m tpukaldi_torch.tools.conv_bwd_phases [--before DIR] [N,L,K,O,pool ...]

Builds variants of `kernels/csrc/conv_pool_bwd.cu` (K5b) and
`conv_ln_bwd.cu` (K6b) with their headers `conv_pool_bwd.cuh` and
`conv_tile.cuh`, each variant replacing a line or a few across the four
files (`VARIANTS`), and at each shape (default: the raw recipes' training
batch, 128 windows of 3200 samples, K = 129, pool 3, at O = 80, SincNet's
layer 0, and O = 128, CNN's) times K5b and K6b (at dropout 0.15,
CNN_raw's) with dX (as the raw recipes run them: their input layer norm
trains) and without it (`need_dx=False`), in turns, forward then backward
through the list:

- `as built`; `R 3`, `R 7` and `R 9` (samples a dX thread computes,
  against 5), `filters 4` and `filters 16` (filters a dX block stages at a
  time, against 8), `threads 256` (dX threads a block, against 128),
  `unroll 2` (dX's chunk loop unrolled twice), `dw warps 4` and `dw warps
  16` (warps of the dW pass, against 8, each owning every 4th or 16th
  tap): the same arithmetic, held to the plain versions, to themselves (two
  calls bitwise equal) and without dX to themselves with it (dW, dgt and
  dbt bitwise equal);
- `ln only`, `dx only`, `dw only` and `sums only`: one kind of launch kept
  (K6b's layer-norm pass; dX; the per-window dW; the window sums, one for
  K5b, three for K6b), the others cut: each launch timed alone, on the
  call with dX (their outputs are wrong);
- with `--before DIR` (given once or more), `before` (then `before 2`,
  ...): DIR's `conv_pool_bwd.cu` and `conv_ln_bwd.cu` built as they are,
  with DIR's two headers (e.g. the parent commit's `csrc`, from `git
  archive <parent> tpukaldi_torch/kernels/csrc` unpacked under `build/`),
  held to the plain versions too.  A K6b whose source takes no ypool is
  the design that recomputes the pooled value and always runs dX (the
  parent's): it is timed with dX only.

Prints the card's name and power limit first, then ptxas's registers for
each variant; exits 1 if a variant with the full arithmetic (or `before`)
disagrees with the plain version, or one of the kernel's own variants is
not bitwise repeatable or changes dW, dgt or dbt without dX.
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
from . import variant_builds
from .variant_builds import median_ms

SHAPES = ((128, 3200, 129, 80, 3), (128, 3200, 129, 128, 3))
DROP = 0.15  # CNN_raw's layer-0 dropout
EPS, SEED = 1e-6, -12345
GRAD_RTOL = 2e-5  # chip_smoke.py's CONV_GRAD_RTOL, of each gradient's max
FILES = ("conv_pool_bwd.cu", "conv_ln_bwd.cu", "conv_pool_bwd.cuh",
         "conv_tile.cuh")
# each kind of launch, cut by `if (false)` in front of it
_LN = "  conv_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, 0, stream>>>("
_DX = ("    conv_pool_dx_tile_kernel<<<dx_grid, kDxThreads, dx_smem, "
       "stream>>>(")
_DW = ("  conv_pool_dw_part_kernel<<<dw_grid, kDwWarps * 32, dw_smem, "
       "stream>>>(")
_SUM = ("  reduce_windows_kernel<<<static_cast<unsigned>(blocks), threads, 0, "
        "stream>>>(")
_K0 = "      for (int k0 = 0; k0 < Kp; k0 += kTapChunk) {"  # the dX chunk loop


def _cut(line: str) -> Tuple[str, str]:
    body = line.lstrip()
    return line, line[:len(line) - len(body)] + "if (false) " + body


def _set(name: str, old: str, new: str) -> Tuple[str, str]:
    return f"constexpr {name} = {old};", f"constexpr {name} = {new};"


# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "R 3": ((_set("int kDxRun", "5", "3"),), True),
    "R 7": ((_set("int kDxRun", "5", "7"),), True),
    "R 9": ((_set("int kDxRun", "5", "9"),), True),
    "filters 4": ((_set("int kDxFilt", "8", "4"),), True),
    "filters 16": ((_set("int kDxFilt", "8", "16"),), True),
    "threads 256": ((_set("int kDxThreads", "128", "256"),), True),
    "unroll 2": (((_K0, "#pragma unroll 2\n" + _K0),), True),
    "dw warps 4": ((_set("int kDwWarps", "8", "4"),), True),
    "dw warps 16": ((_set("int kDwWarps", "8", "16"),), True),
    "ln only": ((_cut(_DX), _cut(_DW), _cut(_SUM)), False),
    "dx only": ((_cut(_LN), _cut(_DW), _cut(_SUM)), False),
    "dw only": ((_cut(_LN), _cut(_DX), _cut(_SUM)), False),
    "sums only": ((_cut(_LN), _cut(_DX), _cut(_DW)), False),
}


def sources(src_dir: str = _build._CSRC) -> Dict[str, str]:
    """The four files as they are in `src_dir`."""
    out = {}
    for name in FILES:
        with open(os.path.join(src_dir, name)) as f:
            out[name] = f.read()
    return out


def variant_files(files: Dict[str, str], table=None
                  ) -> Dict[str, Dict[str, str]]:
    """Each variant's files (of `table`, VARIANTS by default); raises if a
    line it replaces is not in the files exactly once, in all."""
    out = {}
    for name, (reps, _) in (table or VARIANTS).items():
        texts = dict(files)
        for old, new in reps:
            hits = [f for f, t in texts.items() if old in t]
            if len(hits) != 1 or texts[hits[0]].count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the sources once")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        out[name] = texts
    return out


def _runners(libs: Dict[str, ctypes.CDLL], x, w, bias, gt, bt, dz, idx5, idx,
             stats, ypool, pool, before: bool):
    """(k5b(need_dx), k6b(need_dx)) -> their gradients, through the
    variant's C entries, with the wrappers' scratch; `before` is the design
    whose K6b takes no ypool."""
    N, L = x.shape
    K, O = w.shape
    M = (L - K + 1) // pool
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    stream = torch.cuda.current_stream().cuda_stream
    k5 = libs["conv_pool_bwd.cu"].tpk_conv_pool_bwd
    k5.argtypes = [P] * 7 + [I] * 5 + [P]
    k6 = libs["conv_ln_bwd.cu"].tpk_conv_ln_bwd
    k6.argtypes = [P] * (17 if before else 18) + [I] * 5 + [F, I, U, F, I, P]
    threshold, scale, on = conv1d._drop_args(DROP)
    seed_t = conv1d._seed_tensor(SEED, x.device)
    ptr = conv1d._ptr

    def k5b(need_dx):
        dx = torch.empty_like(x) if need_dx else None
        dw = torch.empty_like(w)
        part = torch.empty((N, K, O), device=x.device)
        err = k5(x.data_ptr(), dz.data_ptr(), idx5.data_ptr(), w.data_ptr(),
                 part.data_ptr(), ptr(dx), dw.data_ptr(), N, L, K, O, pool,
                 stream)
        if err != 0:
            raise RuntimeError(f"K5b launch failed with CUDA error {err}")
        return dx, dw

    def k6b(need_dx):
        dyp, dgp, dbp = (torch.empty((N, M, O), device=x.device)
                         for _ in range(3))
        part = torch.empty((N, K, O), device=x.device)
        dx = torch.empty_like(x) if need_dx else None
        dw, dgt, dbt = (torch.empty_like(t) for t in (w, gt, bt))
        res = [idx, stats] + ([] if before else [ypool])
        err = k6(x.data_ptr(), w.data_ptr(), bias.data_ptr(), gt.data_ptr(),
                 bt.data_ptr(), seed_t.data_ptr(), *(t.data_ptr() for t in res),
                 dz.data_ptr(), dyp.data_ptr(), dgp.data_ptr(), dbp.data_ptr(),
                 part.data_ptr(), ptr(dx), dw.data_ptr(), dgt.data_ptr(),
                 dbt.data_ptr(), N, L, K, O, pool, EPS, 1, threshold, scale,
                 on, stream)
        if err != 0:
            raise RuntimeError(f"K6b launch failed with CUDA error {err}")
        return dx, dw, dgt, dbt
    return k5b, k6b


def _inputs(N, L, K, O, pool, seed):
    """x, w, bias, gt, bt and a pooled gradient on the card, as
    chip_smoke.py's conv phase draws them; K5f's idx, and K6f's idx, stats
    and ypool in training."""
    g = torch.Generator().manual_seed(seed)
    M = (L - K + 1) // pool
    x = torch.randn(N, L, generator=g)
    w = torch.randn(K, O, generator=g) / K ** 0.5
    bias = torch.randn(O, generator=g)
    gt = 1 + 0.3 * torch.randn(M, O, generator=g)
    bt = 0.3 * torch.randn(M, O, generator=g)
    dz = torch.randn(N, M, O, generator=g)
    x, w, bias, gt, bt, dz = (t.cuda() for t in (x, w, bias, gt, bt, dz))
    idx5 = conv1d.conv1d_pool(x, w, pool)[1]
    _, idx, stats, ypool = conv1d.conv1d_pool_ln_act(x, w, bias, gt, bt, SEED,
                                                     pool, EPS, True, DROP)
    return x, w, bias, gt, bt, dz, idx5, idx, stats, ypool


def _rel(got, want) -> float:
    return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want) if a is not None)


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
    files = variant_files(sources())
    exact = {name: e for name, (_, e) in VARIANTS.items()}
    old = set()  # the designs whose K6b takes no ypool
    for i, d in enumerate(befores):
        name = "before" + (f" {i + 1}" if i else "")
        files[name] = sources(d)
        exact[name] = True
        if "ypool" not in files[name]["conv_ln_bwd.cu"]:
            old.add(name)
    libs = variant_builds.build_variants(files, "conv_bwd", FILES[:2])
    bad = 0
    for N, L, K, O, pool in shapes:
        tag = f"N={N} L={L} K={K} O={O} pool={pool}"
        args = _inputs(N, L, K, O, pool, N + O)
        x, w, bias, gt, bt, dz, idx5, idx, stats, _ = args
        want5 = conv1d.conv1d_pool_bwd_ref(x, dz, idx5, w, pool)
        g6 = conv1d.conv1d_pool_ln_act_bwd_ref(x, w, bias, gt, bt, SEED, idx,
                                               stats, dz, pool, EPS, True,
                                               DROP)
        want6 = (g6[0], g6[1], g6[3], g6[4])
        fns = {}
        for name, lib in libs.items():
            k5b, k6b = _runners(lib, *args, pool, name in old)
            modes = (True,) if name in old else (True, False)
            for need in modes:
                fns[name, "K5b", need] = lambda f=k5b, n=need: f(n)
                fns[name, "K6b", need] = lambda f=k6b, n=need: f(n)
            if not exact[name]:
                continue
            for kern, fn, want in (("K5b", k5b, want5), ("K6b", k6b, want6)):
                got, again = fn(True), fn(True)
                torch.cuda.synchronize()
                err = _rel(got, want)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                line = (f"{tag} {name} {kern}: max_rel_err={err:.3e} of each "
                        f"gradient's max (rtol {GRAD_RTOL:g}); repeat bitwise "
                        f"equal: {same}")
                ok = err <= GRAD_RTOL and (same or name in old)
                if name not in old:
                    lean = fn(False)
                    torch.cuda.synchronize()
                    kept = lean[0] is None and all(
                        torch.equal(a, b) for a, b in zip(got[1:], lean[1:]))
                    line += f"; without dX the rest bitwise equal: {kept}"
                    ok = ok and kept
                bad += not ok
                print(line, flush=True)
        times: Dict = {key: [] for key in fns}
        for key in list(fns) + list(reversed(fns)):
            times[key].append(median_ms(fns[key]))
        for (name, kern, need), ts in times.items():
            print(f"{tag} {name} {kern} {'with' if need else 'without'} dX: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms", flush=True)
        ms = {key: min(ts) for key, ts in times.items()}
        for kern in ("K5b", "K6b"):
            alone = ", ".join(
                f"{part} {ms[f'{part} only', kern, True]:.3f}"
                for part in ("ln", "dx", "dw", "sums")
                if kern == "K6b" or part != "ln")
            tilings = ", ".join(
                f"{name} {ms[name, kern, True]:.3f}"
                for name in VARIANTS if exact[name] and name != "as built")
            past = "".join(
                f"; {name} {ms[name, kern, True]:.3f}"
                + ("" if name in old else
                   f" (without dX {ms[name, kern, False]:.3f})")
                for name in libs if name.startswith("before"))
            print(f"{tag} {kern}: with dX {ms['as built', kern, True]:.3f} ms, "
                  f"without {ms['as built', kern, False]:.3f}{past}; alone: "
                  f"{alone}; with dX under {tilings}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
