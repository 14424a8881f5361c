"""K7f's and K7b's upper layers timed pass by pass, and their outputs held
bitwise to another build's, on the card.

    python -m tpukaldi_torch.tools.conv_stack_phases [--before DIR ...] [N ...]

Builds variants of `kernels/csrc/conv_stack_fwd.cu` (K7f) and
`conv_stack_bwd.cu` (K7b) with their headers (`FILES`), each variant
replacing a line or a few across the files (`VARIANTS`), and runs the
upper layers of CNN_raw's conv stack (filters 128,60,60,60, K 129,5,5,3,
pools 3,3,3,2 over 3200 samples; layer 0 through the port's K6f, once)
through each build's C entries, at each batch N (default: the training
batch of 128 windows), at dropout 0.15, CNN_raw's:

- `as built`; the GEMM's tilings `chunk 8` and `chunk 32` (input channels
  staged at a time, against 16), `span 128` (positions a block covers at
  most, against 256), `span 256 only` (no smaller spans for a small grid)
  and `c unroll 2` (its channel loop unrolled twice): the same K7f bits,
  held bitwise to `as built`, and K7b's gradients held to the plain
  version;
- `conv only` and `epilogue only` (K7f: the layer-norm launch cut, or the
  conv's), `ln only`, `dw only`, `dx only` and `sums only` (K7b: one kind
  of launch kept; the weights' layout pass runs in each): each pass timed
  alone (their outputs are wrong);
- with `--before DIR` (given once or more), `before` (then `before 2`,
  ...): DIR's sources built as they are (e.g. the parent commit's `csrc`,
  from `git archive <parent> tpukaldi_torch/kernels/csrc` unpacked under
  `build/`); a design whose K7b recomputes the pooled value (no y) is run
  with its own signatures.  Every K7f output (out, idx, stats; y between
  the designs that keep it) and K7b's pooled gradient dy (the first pass's
  output, from the same residuals) held bitwise (`torch.equal`) to `as
  built`'s at `EQUAL_CASES`: CNN_raw's stack at 128 windows, the cuda
  test's odd stack (13 windows of 1100 samples, pools 3/3/2), drop 0 and
  0.15, relu on and off, and a 1,024-window slice of the serving batch
  (without residuals).

Each timing is of the upper layers (three launches of the entry), a call
alone, the median of 5 between two events (the host's share included),
and on the device alone, 20 calls queued behind a sleep of the card
(`_queued_ms`), forward then backward through the builds; beside them,
the whole K7f and K7b per build (K6f + the upper layers; the upper layers
+ K6b, through the port's wrappers for layer 0), and with `--before`, K7f
at the 32,000-window serving batch.  Prints the card's name and power
limit first, then ptxas's registers; exits 1 if a build with the full
arithmetic disagrees with the plain version (chip_smoke.py's STACK_ATOL,
STACK_GRAD_RTOL) or with `as built` where it must be bitwise, or if two
K7b calls of `as built` differ.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from ..kernels import _build, conv1d, conv_stack
from ..train.chunk_runtime import resolve_device
from .conv_bwd_phases import _cut, _set, variant_files
from . import variant_builds
from .conv_fwd_phases import _queued_ms
from .variant_builds import build_variants, median_ms

FILES = ("conv_stack_fwd.cu", "conv_stack_bwd.cu", "stack_tile.cuh",
         "conv_tile.cuh", "conv_pool_bwd.cuh", "persist_grid.cuh")
# CNN_raw's stack (cfg/TIMIT/CNN_raw.cfg's cnn_* fields), as chip_smoke.py
# runs it
L, LEN_FILT, N_FILT, POOLS = 3200, (129, 5, 5, 3), (128, 60, 60, 60), \
    (3, 3, 3, 2)
# the cuda test's odd stack (tests/test_torch_port_conv_stack.py)
ODD = (13, 1100, (129, 5, 3), (128, 60, 60), (3, 3, 2))
DROP = 0.15  # CNN_raw's dropout
EPS, SEED = 1e-6, -12345
STACK_ATOL, STACK_GRAD_RTOL = 5e-5, 1e-4  # chip_smoke.py's
SERVE_N, SERVE_SLICE = 32000, 1024
# (N, L, K, filters, pools, drop, relu, residuals)
EQUAL_CASES = tuple(
    (N, l_, k, f, p, d, r, True)
    for N, l_, k, f, p in ((128, L, LEN_FILT, N_FILT, POOLS), ODD)
    for d, r in ((0.0, True), (DROP, True), (DROP, False))) + (
    (SERVE_SLICE, L, LEN_FILT, N_FILT, POOLS, 0.0, True, False),)

_LN_FWD = ("  stack_ln_fwd_kernel<<<grid, tpk::kLnWarps * 32, ln_smem, "
           "stream>>>(")
_CONV = "  err = tpk::dispatch_taps<ConvLaunch>(K, a, stream);"
_LN_BWD = ("  stack_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, ln_smem, "
           "stream>>>(")
_DW = "    stack_dw_kernel<K><<<grid, 256, dw_smem_bytes(K), stream>>>("
_DX = "    err = tpk::launch_gemm<K, false>(g, a.N, stream);"
_SUM = ("  reduce_windows_kernel<<<static_cast<unsigned>(blocks), threads, 0, "
        "stream>>>(")
_CLOOP = "  for (int c = 0; c < cn; ++c) {"  # the GEMM's channel loop

# name -> (replacements, whether the arithmetic is the kernel's)
VARIANTS = {
    "as built": ((), True),
    "chunk 8": ((_set("int kGemmChunk", "16", "8"),), True),
    "chunk 32": ((_set("int kGemmChunk", "16", "32"),), True),
    "span 128": ((_set("int kGemmMaxPos", "256", "128"),), True),
    "span 256 only": ((_set("int kGemmMinPos", "64", "256"),), True),
    "c unroll 2": (((_CLOOP, "#pragma unroll 2\n" + _CLOOP),), True),
    "conv only": ((_cut(_LN_FWD),), False),
    "epilogue only": ((_cut(_CONV),), False),
    "ln only": ((_cut(_DW), _cut(_DX), _cut(_SUM)), False),
    "dw only": ((_cut(_LN_BWD), _cut(_DX), _cut(_SUM)), False),
    "dx only": ((_cut(_LN_BWD), _cut(_DW), _cut(_SUM)), False),
    "sums only": ((_cut(_LN_BWD), _cut(_DW), _cut(_DX)), False),
}
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
SOURCES = FILES[:2]


def sources(src_dir: str = _build._CSRC) -> Dict[str, str]:
    """The files as they are in `src_dir`."""
    return variant_builds.sources(src_dir, FILES)


class Build:
    """One build's upper layers through its C entries: `fwd` and `bwd` over
    every upper layer, with the wrappers' scratch.  `keeps_y` is False for
    the design whose K7b recomputes the pooled value, which has no scratch
    entries (its own signatures: no y, no scratch; K7b takes the bias and
    separate dy, dgp, dbp and dw_part buffers)."""

    def __init__(self, libs: Dict[str, ctypes.CDLL]):
        keeps_y = hasattr(libs["conv_stack_fwd.cu"],
                          "tpk_stack_upper_fwd_scratch")
        self.keeps_y = keeps_y
        self.f = libs["conv_stack_fwd.cu"].tpk_stack_upper_fwd
        self.b = libs["conv_stack_bwd.cu"].tpk_stack_upper_bwd
        if keeps_y:
            self.f.argtypes = [_P] * 11 + [_I] * 7 + [_U, _F, _I, _U, _F, _I, _P]
            self.b.argtypes = [_P] * 12 + [_I] * 7 + [_U, _F, _I, _U, _F, _I, _P]
            self.fs = libs["conv_stack_fwd.cu"].tpk_stack_upper_fwd_scratch
            self.fs.argtypes, self.fs.restype = [_I] * 3, ctypes.c_long
            self.bs = libs["conv_stack_bwd.cu"].tpk_stack_upper_bwd_scratch
            self.bs.argtypes, self.bs.restype = [_I] * 6, ctypes.c_long
        else:
            self.f.argtypes = [_P] * 9 + [_I] * 7 + [_U, _F, _I, _U, _F, _I, _P]
            self.b.argtypes = [_P] * 17 + [_I] * 7 + [_U, _F, _I, _U, _F, _I, _P]
        self.f.restype = self.b.restype = ctypes.c_int

    def fwd(self, z, ups, pools, seed_t, drop, relu, residuals=True):
        """Per upper layer (out, idx, stats, y); y None for a design that
        keeps none (and out, without residuals)."""
        res = []
        stream = torch.cuda.current_stream().cuda_stream
        threshold, scale, on = conv1d._drop_args(drop)
        for i, (w, b, g, be) in enumerate(ups, 1):
            N, lin, C = z.shape
            O, _, K = w.shape
            P = pools[i]
            M = (lin - K + 1) // P
            out = torch.empty((N, M, O), device=z.device)
            idx = stats = None
            y = out
            if residuals:
                idx = torch.empty((N, M, O), device=z.device, dtype=torch.int8)
                stats = torch.empty((N, 2, O), device=z.device)
                y = torch.empty_like(out)
            head = (z.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                    be.data_ptr(), seed_t.data_ptr() if on else None)
            tail = (N, lin, C, K, O, P, M, i * conv_stack.SALT, EPS, int(relu),
                    threshold, scale, on, stream)
            if self.keeps_y:
                scratch = torch.empty(self.fs(C, K, O), device=z.device)
                err = self.f(*head, y.data_ptr(), out.data_ptr(),
                             conv1d._ptr(idx), conv1d._ptr(stats),
                             scratch.data_ptr(), *tail)
            else:
                err = self.f(*head, out.data_ptr(), conv1d._ptr(idx),
                             conv1d._ptr(stats), *tail)
                y = None
            if err != 0:
                raise RuntimeError(f"K7f layer {i} failed with error {err}")
            res.append((out, idx, stats, y if residuals else None))
            z = out
        return res

    def bwd(self, ups, pools, res, dz, seed_t, drop, relu, feed=None):
        """Per upper layer from the top: (dy, dh, dW, dgamma, dbeta) on the
        residuals `res` (per layer (h, idx, stats, y)); each layer takes the
        dh of the layer above, or with `feed` (per layer from the top, as
        another build's run gave them) its own incoming gradient, so that
        every layer's dy compares bitwise across builds."""
        grads = []
        stream = torch.cuda.current_stream().cuda_stream
        threshold, scale, on = conv1d._drop_args(drop)
        d = dz
        for i in range(len(ups), 0, -1):
            if feed is not None:
                d = feed[len(ups) - i]
            w, b, g, be = ups[i - 1]
            h, idx, stats, y = res[i - 1]
            N, lin, C = h.shape
            O, _, K = w.shape
            P, M = pools[i], idx.shape[1]
            dh = torch.empty_like(h)
            flat = torch.empty(O * C * K + 2 * M * O, device=h.device)
            dw, dg, dbe = (part.view(t.shape) for part, t in zip(
                flat.split([O * C * K, M * O, M * O]), (w, g, be)))
            tail = (N, lin, C, K, O, P, M, i * conv_stack.SALT, EPS, int(relu),
                    threshold, scale, on, stream)
            seed = seed_t.data_ptr() if on else None
            if self.keeps_y:
                scratch = torch.empty(self.bs(N, C, K, O, P, M), device=h.device)
                err = self.b(h.data_ptr(), w.data_ptr(), g.data_ptr(),
                             be.data_ptr(), seed, idx.data_ptr(),
                             stats.data_ptr(), y.data_ptr(), d.data_ptr(),
                             scratch.data_ptr(), dh.data_ptr(),
                             flat.data_ptr(), *tail)
                dy = scratch[:N * M * O].view(N, M, O)
            else:
                dy, dgp, dbp = (torch.empty((N, M, O), device=h.device)
                                for _ in range(3))
                part = torch.empty((N, O, C, K), device=h.device)
                err = self.b(h.data_ptr(), w.data_ptr(), b.data_ptr(),
                             g.data_ptr(), be.data_ptr(), seed, idx.data_ptr(),
                             stats.data_ptr(), d.data_ptr(), dy.data_ptr(),
                             dgp.data_ptr(), dbp.data_ptr(), part.data_ptr(),
                             dh.data_ptr(), dw.data_ptr(), dg.data_ptr(),
                             dbe.data_ptr(), *tail)
            if err != 0:
                raise RuntimeError(f"K7b layer {i} failed with error {err}")
            grads.append((dy, dh, dw, dg, dbe))
            d = dh
        return grads


def _stack(N, l_, len_filt, n_filt, pools, seed=17):
    """x, w0, bias0, gt0, bt0, the upper layers and an output gradient on
    the card, as chip_smoke.py's stack phase draws them."""
    g = torch.Generator().manual_seed(seed)
    geo = conv_stack.stack_geometry(l_, len_filt, pools)
    K0, M0, O0 = len_filt[0], geo[0][4], n_filt[0]
    first = [torch.randn(N, l_, generator=g),
             torch.randn(K0, O0, generator=g) / K0 ** 0.5,
             torch.randn(O0, generator=g),
             1 + 0.3 * torch.randn(M0, O0, generator=g),
             0.3 * torch.randn(M0, O0, generator=g)]
    ups = []
    for (lin, K, P, ct, M), C, O in zip(geo[1:], n_filt, n_filt[1:]):
        ups.append(tuple(t.cuda() for t in (
            torch.randn(O, C, K, generator=g) / (C * K) ** 0.5,
            torch.randn(O, generator=g), 1 + 0.3 * torch.randn(M, O, generator=g),
            0.3 * torch.randn(M, O, generator=g))))
    dz = torch.randn(N, geo[-1][4], n_filt[-1], generator=g)
    return [t.cuda() for t in first], tuple(ups), dz.cuda()


def _layer0(first, pools, drop, relu, residuals=True):
    """Layer 0 through the port's K6f: (z0, idx0, stats0, ypool0), z0
    contiguous, as the C entries read it."""
    z0, *rest = conv1d.conv1d_pool_ln_act(*first, SEED, pools[0], EPS, relu,
                                          drop, residuals)
    return (z0.contiguous(), *rest)


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _grad_err(got, want) -> float:
    """The worst error relative to each tensor's max of a build's K7b
    (per layer from the top: dy, dh, dW, dgamma, dbeta) against
    `upper_bwd_ref`'s (layer 0's output gradient, per layer from the bottom
    (dW, dbias, dgamma, dbeta))."""
    d0, dups = want
    errs = [_rel(got[-1][1], d0)]
    for g_, w_ in zip(reversed(got), dups):
        errs += [_rel(g_[2], w_[0]), _rel(g_[3], w_[2]), _rel(g_[4], w_[3])]
    return max(errs)


def _check(builds, exact, case) -> int:
    """Every exact build at `case` against `as built`, bitwise, and `as
    built` against the plain version; one line per build; the count of
    failures."""
    N, l_, len_filt, n_filt, pools, drop, relu, residuals = case
    tag = (f"N={N} L={l_} K={len_filt} filters={n_filt} pools={pools} "
           f"drop={drop} relu={relu}" + ("" if residuals else " serving"))
    first, ups, dz = _stack(N, l_, len_filt, n_filt, pools, seed=N)
    seed_t = conv1d._seed_tensor(SEED, first[0].device)
    bad = 0
    with torch.inference_mode():
        z0 = _layer0(first, pools, drop, relu, residuals)[0]
        ref = builds["as built"].fwd(z0, ups, pools, seed_t, drop, relu,
                                     residuals)
        # the plain upper layers on the same z0, and K7b's plain version on
        # as built's residuals
        drops = (drop,) * len(pools)
        outs, plain = conv_stack.upper_ref(z0, ups, SEED, pools, EPS, relu,
                                           drops)
        maps = [r[0] for r in ref]
        want_maps = [p[0] for p in plain[1:]] + [outs]
        err = max((a - p).abs().max().item() for a, p in zip(maps, want_maps))
        if residuals:
            err = max([err] + [(a[k] - p[k]).abs().max().item()
                               for a, p in zip(ref, plain) for k in (2, 3)])
        flips = [(a[1] != p[1]).sum().item() for a, p in zip(ref, plain)
                 if residuals]
        print(f"{tag} as built K7f: max_abs_err={err:.3e} over out, stats and "
              f"y (atol {STACK_ATOL:g}), argmax flips {flips}", flush=True)
        bad += not err <= STACK_ATOL
        res = None
        if residuals:
            res = [(h_, r[1], r[2], r[3])
                   for h_, r in zip([z0] + [r[0] for r in ref[:-1]], ref)]
            got = builds["as built"].bwd(ups, pools, res, dz, seed_t, drop,
                                         relu)
            again = builds["as built"].bwd(ups, pools, res, dz, seed_t, drop,
                                           relu)
            feed = [dz] + [g_[1] for g_ in got[:-1]]
            want = conv_stack.upper_bwd_ref(ups, SEED, res, dz, pools, EPS,
                                            relu, drops)
            rel = _grad_err(got, want)
            same = all(torch.equal(a, b) for g_, g2 in zip(got, again)
                       for a, b in zip(g_, g2))
            print(f"{tag} as built K7b: max_rel_err={rel:.3e} of each "
                  f"gradient's max (rtol {STACK_GRAD_RTOL:g}); a second call "
                  f"bitwise equal: {same}", flush=True)
            bad += not (rel <= STACK_GRAD_RTOL and same)
        for name, build in builds.items():
            if name == "as built" or not exact[name]:
                continue
            out = build.fwd(z0, ups, pools, seed_t, drop, relu, residuals)
            keys = (0, 1, 2, 3) if build.keeps_y else (0, 1, 2)
            fsame = all((a[k] is None and b[k] is None) or torch.equal(a[k], b[k])
                        for a, b in zip(out, ref) for k in keys)
            line = f"{tag} {name}: K7f bitwise as built {fsame}"
            ok = fsame
            if residuals:
                g2 = build.bwd(ups, pools, res, dz, seed_t, drop, relu, feed)
                dsame = all(torch.equal(a[0], b[0]) for a, b in zip(g2, got))
                rel = _grad_err(g2, want)
                line += (f"; K7b dy bitwise as built {dsame}, gradients "
                         f"max_rel_err={rel:.3e}")
                ok = ok and dsame and rel <= STACK_GRAD_RTOL
            bad += not ok
            print(line, flush=True)
    return bad


def _times(builds, N, seed_t) -> None:
    """Each build's upper layers (forward with residuals, then backward on
    as built's residuals), a call alone and on the device alone, in turns;
    then the whole K7f and K7b of each build with the full arithmetic."""
    first, ups, dz = _stack(N, L, LEN_FILT, N_FILT, POOLS)
    tag = f"N={N} CNN_raw's stack drop={DROP}"
    with torch.inference_mode():
        z0, idx0, stats0, ypool0 = _layer0(first, POOLS, DROP, True)
        ref = builds["as built"].fwd(z0, ups, POOLS, seed_t, DROP, True)
        res = [(h, r[1], r[2], r[3])
               for h, r in zip([z0] + [r[0] for r in ref[:-1]], ref)]
        d0 = builds["as built"].bwd(ups, POOLS, res, dz, seed_t, DROP,
                                    True)[-1][1]
        fns = {}
        for name, b in builds.items():
            fns[name, "K7f upper"] = (
                lambda b=b: b.fwd(z0, ups, POOLS, seed_t, DROP, True))
            fns[name, "K7b upper"] = (
                lambda b=b: b.bwd(ups, POOLS, res, dz, seed_t, DROP, True))
        k6f = lambda: _layer0(first, POOLS, DROP, True)  # noqa: E731
        k6b = lambda: conv1d.conv1d_pool_ln_act_bwd(  # noqa: E731
            *first, seed_t, idx0, stats0, ypool0, d0, POOLS[0], EPS, True,
            DROP, True)
        fns["layer 0", "K6f"], fns["layer 0", "K6b"] = k6f, k6b
        alone: Dict = {key: [] for key in fns}
        device: Dict = {key: [] for key in fns}
        for key in list(fns) + list(reversed(fns)):
            alone[key].append(median_ms(fns[key]))
            device[key].append(_queued_ms(fns[key]))
    for (name, what), ts in alone.items():
        print(f"{tag} {name} {what}: "
              f"{' / '.join(f'{t:.4f}' for t in ts)} ms a call alone, "
              f"{' / '.join(f'{t:.4f}' for t in device[name, what])} ms on "
              f"the device", flush=True)
    for what, by in (("alone", alone), ("on the device", device)):
        ms = {key: min(ts) for key, ts in by.items()}
        for kern, zero in (("K7f", "K6f"), ("K7b", "K6b")):
            whole = "; ".join(
                f"{name} {ms[name, f'{kern} upper'] + ms['layer 0', zero]:.4f}"
                for name in builds if VARIANTS.get(name, ((), True))[1])
            parts = ", ".join(f"{name} {ms[name, f'{kern} upper']:.4f}"
                              for name in builds)
            print(f"{tag} {kern} {what}: upper layers {parts}; with layer 0 "
                  f"({zero} {ms['layer 0', zero]:.4f}): {whole}", flush=True)


def _serve(builds, names, seed_t) -> None:
    """K7f's upper layers at the serving batch (no residuals) for each of
    `names`, in turns, beside K6f."""
    first, ups, _ = _stack(1, L, LEN_FILT, N_FILT, POOLS)
    first[0] = torch.randn(SERVE_N, L, device="cuda")
    with torch.inference_mode():
        z0 = _layer0(first, POOLS, 0.0, True, False)[0]
        times: Dict = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(median_ms(lambda: builds[name].fwd(
                z0, ups, POOLS, seed_t, 0.0, True, False), 3))
        k6 = median_ms(lambda: _layer0(first, POOLS, 0.0, True, False), 3)
    print(f"serving N={SERVE_N} K7f upper layers: " + "; ".join(
        f"{name} " + " / ".join(f"{t:.3f}" for t in ts) + " ms"
        for name, ts in times.items()) + f"; K6f {k6:.3f} ms", flush=True)


def main(argv: List[str]) -> int:
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    befores = []
    while argv[:1] == ["--before"]:
        befores.append(argv[1])
        argv = argv[2:]
    batches = tuple(int(a) for a in argv) or (128,)
    files = variant_files(sources(), VARIANTS)
    exact = {name: e for name, (_, e) in VARIANTS.items()}
    names = []
    for i, d in enumerate(befores):
        name = "before" + (f" {i + 1}" if i else "")
        files[name] = sources(d)
        exact[name] = True
        names.append(name)
    libs = build_variants(files, "conv_stack", SOURCES)
    builds = {name: Build(lib) for name, lib in libs.items()}
    seed_t = conv1d._seed_tensor(SEED, torch.device("cuda"))
    bad = 0
    for case in EQUAL_CASES:
        bad += _check(builds, exact, case)
    for N in batches:
        _times(builds, N, seed_t)
    if befores:
        _serve(builds, ["as built", *names], seed_t)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
