"""K2f's step split by phase, and its tiling alternatives, on the card.

    python -m tpukaldi_torch.tools.lstm_fwd_phases [T,B,H ...]

Builds variants of `kernels/csrc/lstm_fwd.cu` by replacing one line each
(`variants`) and times every variant at each shape (default: the LSTM
recipe's serving and training shapes, a two-pass batch and the QLSTM's
width), in turns, forward then backward through the list:

- `as built`; `rows 8`, `unroll 2` (the k loop), `chunk 128`, `chunk 64`:
  the same arithmetic, held to the plain version (`lstm_recurrence_ref`);
- `no product` (the k loop runs no step), `no h stream` (no chunk of h is
  staged) and `neither`: cut phases, whose outputs are wrong.  The step's
  product is `no h stream` - `neither`, its h stream `no product` -
  `neither`, and `neither` is the barrier, the cell and the rest.

Prints the card's name and power limit first; exits 1 if a variant with
the full arithmetic disagrees with the plain version or between two calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from ..kernels import _build, lstm
from ..train.chunk_runtime import resolve_device

SHAPES = ((778, 64, 550), (1000, 16, 550), (50, 136, 550), (200, 96, 1024))
ATOL = 1e-4  # as chip_smoke.py's KERNEL_ATOL
_K_LOOP = "          for (int kk = s_thr; kk < ksteps; kk += S) {"
_STAGE = "        for (int i = tid; i < mp * per_row; i += kThreads) {"
_ROWS = "constexpr int kRows = 4;"
_CHUNK = "constexpr int kMaxChunk = 256;"
_NO_PRODUCT = (_K_LOOP, _K_LOOP.replace("kk < ksteps", "kk < 0"))
_NO_STREAM = (_STAGE, _STAGE.replace("i < mp * per_row", "i < 0"))
# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "rows 8": (((_ROWS, "constexpr int kRows = 8;"),), True),
    "unroll 2": (((_K_LOOP, "#pragma unroll 2\n" + _K_LOOP),), True),
    "chunk 128": (((_CHUNK, "constexpr int kMaxChunk = 128;"),), True),
    "chunk 64": (((_CHUNK, "constexpr int kMaxChunk = 64;"),), True),
    "no product": ((_NO_PRODUCT,), False),
    "no h stream": ((_NO_STREAM,), False),
    "neither": ((_NO_PRODUCT, _NO_STREAM), False),
}


def variants(source: str, table=None) -> Dict[str, str]:
    """Each variant's source (of `table`, VARIANTS by default); raises if a
    line it replaces is not in `source` exactly once."""
    out = {}
    for name, (reps, _) in (table or VARIANTS).items():
        text = source
        for old, new in reps:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all(sources: Dict[str, str],
               stem: str = "lstm_fwd") -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once, into build/tpukaldi_torch/variants/
    as `<stem>_v<i>`."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = os.path.join(out_dir, f"{stem}_v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{stem}_v{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-o",
               lib, src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        regs = [line.split(":", 1)[1].strip() for line in report.splitlines()
                if "registers" in line]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def _runner(lib: ctypes.CDLL, ff, u, mask):
    """fn() -> (h, c) through `lib`'s C entry, with the wrapper's scratch
    (B padded to 8, enough for either tile height)."""
    T, B, H4 = ff.shape
    H = H4 // 4
    entry = lib.tpk_lstm_fwd
    entry.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    upk = lstm._pack(u, H, torch.float32)

    def fn():
        h = torch.empty(T, B, H, device=ff.device)
        c = torch.empty_like(h)
        hbuf = torch.zeros((2, lstm._pad(B, 8), lstm._pad(H, 4)), device=ff.device)
        bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
        err = entry(ff.data_ptr(), upk.data_ptr(), mask.data_ptr(), h.data_ptr(),
                    c.data_ptr(), hbuf.data_ptr(), bar.data_ptr(), T, B, H,
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return h, c
    return fn


def _inputs(T, B, H, seed):
    g = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, 4 * H, generator=g)
    u = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    mask = (torch.rand(B, H, generator=g) < 0.8).float()
    return ff.cuda(), u.cuda(), mask.cuda()


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shapes: Tuple = (tuple(tuple(int(x) for x in a.split(",")) for a in argv)
                     or SHAPES)
    with open(os.path.join(_build._CSRC, lstm.SOURCE)) as f:
        libs = _build_all(variants(f.read()))
    bad = 0
    for T, B, H in shapes:
        ff, u, mask = _inputs(T, B, H, T + B)
        fns = {name: _runner(lib, ff, u, mask) for name, lib in libs.items()}
        want = lstm.lstm_recurrence_ref(ff, u, mask)
        for name, fn in fns.items():
            if not VARIANTS[name][1]:
                continue
            got, again = fn(), fn()
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            bad += not (err <= ATOL and same)
            print(f"T={T} B={B} H={H} {name}: max_abs_err={err:.3e} (atol "
                  f"{ATOL:g}), repeat bitwise equal: {same}", flush=True)
        times = {name: [] for name in fns}
        for name in list(fns) + list(reversed(fns)):
            times[name].append(median_ms(fns[name]))
        for name, ts in times.items():
            print(f"T={T} B={B} H={H} {name}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms, "
                  f"{1e3 * min(ts) / T:.2f} us per step", flush=True)
        step = {name: 1e3 * min(ts) / T for name, ts in times.items()}
        print(f"T={T} B={B} H={H} step {step['as built']:.2f} us: product "
              f"{step['no h stream'] - step['neither']:.2f}, h stream "
              f"{step['no product'] - step['neither']:.2f}, barrier, cell and "
              f"the rest {step['neither']:.2f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
