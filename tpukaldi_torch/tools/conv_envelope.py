"""K5f, K5b, K6f and K6b across their envelope (1 <= K <= 512, 1 <= pool
<= 32), on the card.

    python -m tpukaldi_torch.tools.conv_envelope [--before DIR]

At every shape of `OLD_SHAPES` (the raw recipes' training batch, chip_smoke.py's
odd, CNN_fbank and launch-path shapes, a spread of K and pool inside K <=
129 and pool <= 12) and `NEW_SHAPES` (SincNet's 251 taps, 25-ms 401-tap
filters, 512 taps, pools of 13-32, K either side of the dW pass's tap
group, row blocks), the four kernels as built against their plain
versions: the forwards' outputs within ATOL with at most MAX_FLIPS argmax
flips and the hash mask's dropped elements exactly, the backwards given
the kernel's own idx within GRAD_RTOL of each gradient's max, without dX
their other gradients bitwise those with it, and two calls bitwise equal
(K6 where a window fits its block).  Each call: K5f with and without idx,
K5b with and without dX, K6f with and without residuals and K6b with and
without dX, at drop 0 and DROP, relu on and off.

With `--before DIR` (e.g. the parent commit's `csrc`, from `git archive
<parent> tpukaldi_torch/kernels/csrc` unpacked under `build/`), DIR's four
sources and headers built as they are: at `OLD_SHAPES` every output of
every call bitwise DIR's, and the four kernels timed at the training batch
(O = 80 and 128) in turns, DIR's, as built, as built, DIR's.  Then each
kernel and its plain version timed at 251 taps and at a pool of 16.

Prints the card's name and power limit, ptxas's registers of each build
and each forward's launch; exits 1 on any disagreement.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List

import torch

from ..kernels import _build, conv1d
from ..train.chunk_runtime import resolve_device
from .variant_builds import Use, build_variants, median_ms, sources

SRCS = (conv1d.SOURCE, conv1d.BWD_SOURCE, conv1d.LN_SOURCE,
        conv1d.LN_BWD_SOURCE)
FILES = SRCS + ("conv_fwd.cuh", "conv_tile.cuh", "conv_pool_bwd.cuh",
                "persist_grid.cuh")
OLD_SHAPES = ((128, 3200, 129, 80, 3), (128, 3200, 129, 128, 3),
              (13, 701, 100, 7, 3), (128, 440, 10, 80, 3),
              (2, 4501, 129, 20, 3), (2, 20001, 129, 16, 1),
              (2, 260, 5, 20, 12), (3, 517, 17, 40, 5), (2, 191, 50, 9, 1),
              (1, 333, 129, 128, 6), (2, 999, 3, 33, 2),
              (2, 1201, 64, 100, 4))
NEW_SHAPES = ((128, 3200, 251, 80, 3), (128, 3200, 251, 128, 3),
              (16, 3200, 251, 80, 16), (3, 701, 251, 7, 3),
              (2, 3200, 401, 40, 5), (2, 3200, 512, 33, 32),
              (3, 900, 137, 16, 13), (2, 1000, 200, 20, 24),
              (4, 1500, 300, 128, 17), (2, 20001, 251, 16, 1),
              (2, 20001, 300, 16, 25), (5, 600, 136, 12, 3),
              (5, 600, 137, 12, 3), (2, 513, 512, 8, 2),
              (128, 440, 10, 80, 13), (2, 3200, 251, 80, 32))
TIMED = ((128, 3200, 129, 80, 3), (128, 3200, 129, 128, 3))
TIMED_NEW = ((128, 3200, 251, 80, 3), (128, 3200, 251, 128, 3),
             (16, 3200, 251, 80, 16))
EPS, SEED, DROP = 1e-6, -12345, 0.15
# chip_smoke.py's CONV_ATOL, CONV_GRAD_RTOL and CONV_MAX_FLIPS
ATOL, GRAD_RTOL, MAX_FLIPS = 1e-5, 2e-5, 10


def _inputs(N, L, K, O, pool, seed):
    """x, w, bias, gt, bt and a pooled gradient on the card, as
    chip_smoke.py's conv phase draws them."""
    g = torch.Generator().manual_seed(seed)
    M = (L - K + 1) // pool
    x = torch.randn(N, L, generator=g)
    w = torch.randn(K, O, generator=g) / K ** 0.5
    bias = torch.randn(O, generator=g)
    gt = 1 + 0.3 * torch.randn(M, O, generator=g)
    bt = 0.3 * torch.randn(M, O, generator=g)
    dy = torch.randn(N, M, O, generator=g)
    return [t.cuda() for t in (x, w, bias, gt, bt, dy)]


def _k6_fits(L, K, pool) -> bool:
    fn = _build.load(conv1d.LN_SOURCE).tpk_conv_ln_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_long
    return fn(L, K, pool) <= conv1d.SMEM_LIMIT


def _calls(x, w, bias, gt, bt, dy, pool, k6: bool) -> dict:
    """Every call's outputs at one shape, through the wrappers."""
    out = {}
    y, idx = conv1d.conv1d_pool(x, w, pool)
    out["K5f"] = (y, idx)
    out["K5f serve"] = conv1d.conv1d_pool(x, w, pool, need_idx=False)[:1]
    out["K5b"] = conv1d.conv1d_pool_bwd(x, dy, idx, w, pool)
    out["K5b no dX"] = conv1d.conv1d_pool_bwd(x, dy, idx, w, pool, False)
    for drop in (0.0, DROP) if k6 else ():
        for relu in (True, False):
            ln = (x, w, bias, gt, bt, SEED, pool, EPS, relu, drop)
            tag = f" drop={drop} relu={relu}"
            res = conv1d.conv1d_pool_ln_act(*ln)
            out["K6f" + tag] = res
            out["K6f serve" + tag] = conv1d.conv1d_pool_ln_act(
                *ln, residuals=False)[:1]
            out["K6b" + tag] = conv1d.conv1d_pool_ln_act_bwd(
                *ln[:6], *res[1:], dy, *ln[6:])
            out["K6b no dX" + tag] = conv1d.conv1d_pool_ln_act_bwd(
                *ln[:6], *res[1:], dy, *ln[6:], False)
    torch.cuda.synchronize()
    return out


def _same(a, b) -> bool:
    return all((u is None and v is None) or (
        u is not None and v is not None and torch.equal(u, v))
        for u, v in zip(a, b))


def _vs_plain(got, x, w, bias, gt, bt, dy, pool) -> List[str]:
    """What disagrees with the plain versions, one line each."""
    bad = []
    y, idx = got["K5f"]
    y_r, idx_r = conv1d.conv1d_pool_ref(x, w, pool)
    err, flips = (y - y_r).abs().max().item(), (idx != idx_r).sum().item()
    if not (err <= ATOL and flips <= MAX_FLIPS
            and torch.equal(got["K5f serve"][0], y)):
        bad.append(f"K5f err {err:.3e}, flips {flips}")
    want = conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, pool)
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got["K5b"], want))
    if not (err <= GRAD_RTOL and got["K5b no dX"][0] is None
            and torch.equal(got["K5b no dX"][1], got["K5b"][1])):
        bad.append(f"K5b rel err {err:.3e}")
    for key in [k for k in got if k.startswith("K6f drop")]:
        z, idx6, stats, ypool = got[key]
        tag = key[3:]
        drop = float(tag.split()[0][5:])
        relu = tag.endswith("True")
        ln = (x, w, bias, gt, bt, SEED, pool, EPS, relu, drop)
        z_r, idx6_r, stats_r = conv1d.conv1d_pool_ln_act_ref(*ln)
        err = max((z - z_r).abs().max().item(),
                  (stats - stats_r).abs().max().item(),
                  (ypool - conv1d._pooled_at(conv1d._conv(x, w), idx6,
                                             pool)).abs().max().item())
        flips = (idx6 != idx6_r).sum().item()
        dropped = 0
        if drop:
            keep = conv1d.drop_mask(SEED, torch.arange(x.shape[0],
                                                       device=x.device),
                                    z.shape[1], z.shape[2], drop)
            dropped = ((~keep & (z != 0))
                       | (keep & (z == 0) & (z_r.abs() > ATOL))).sum().item()
        if not (err <= ATOL and flips <= MAX_FLIPS and dropped == 0
                and torch.equal(got["K6f serve" + tag][0], z)):
            bad.append(f"K6f{tag} err {err:.3e}, flips {flips}, "
                       f"dropped {dropped}")
        grads = got["K6b" + tag]
        want = conv1d.conv1d_pool_ln_act_bwd_ref(*ln[:6], idx6, stats, dy,
                                                 *ln[6:])
        err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  .item() for i, (a, b) in enumerate(zip(grads, want))
                  if i != 2)
        no_dx = got["K6b no dX" + tag]
        if not (err <= GRAD_RTOL and no_dx[0] is None
                and _same(no_dx[1:], grads[1:])):
            bad.append(f"K6b{tag} rel err {err:.3e}")
    return bad


def _regs(name: str, libs: Dict[str, ctypes.CDLL]) -> None:
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
    before = None
    if argv[:1] == ["--before"]:
        before = build_variants({"before": sources(argv[1], FILES)},
                                 "conv_envelope", SRCS)["before"]
    built = {src: _build.load(src) for src in SRCS}
    _regs("as built", built)
    bad = 0
    with torch.inference_mode():
        for shape in OLD_SHAPES + NEW_SHAPES:
            N, L, K, O, pool = shape
            ins = _inputs(*shape, seed=sum(shape))
            k6 = _k6_fits(L, K, pool)
            with Use(built):
                got = _calls(*ins, pool, k6)
                repeat = _calls(*ins, pool, k6)
            problems = _vs_plain(got, *ins, pool)
            problems += [f"{k} differs on a repeat" for k in got
                         if not _same(got[k], repeat[k])]
            if before is not None and shape in OLD_SHAPES:
                with Use(before):
                    old = _calls(*ins, pool, k6)
                problems += [f"{k} differs from the before build" for k in got
                             if not _same(got[k], old[k])]
            print(f"N={N} L={L} K={K} O={O} pool={pool}: {len(got)} calls"
                  + (", bitwise the before build" if before is not None
                     and shape in OLD_SHAPES else "")
                  + (", K6 refused (a window needs more shared memory)"
                     if not k6 else "") + ": "
                  + ("; ".join(problems) if problems else "ok"), flush=True)
            if K > 129 or pool > 12:
                with Use(built):
                    print(f"  K5f {conv1d.fwd_plan(conv1d.SOURCE, *shape)}"
                          + (f"\n  K6f {conv1d.fwd_plan(conv1d.LN_SOURCE, *shape)}"
                             if k6 else ""), flush=True)
            bad += bool(problems)
        for shape in TIMED + TIMED_NEW:
            N, L, K, O, pool = shape
            x, w, bias, gt, bt, dy = _inputs(*shape, seed=1)
            ln = (x, w, bias, gt, bt, SEED, pool, EPS, True, 0.0)
            with Use(built):
                _, idx = conv1d.conv1d_pool(x, w, pool)
                _, idx6, stats, ypool = conv1d.conv1d_pool_ln_act(*ln)
            kernels = {
                "K5f": lambda: conv1d.conv1d_pool(x, w, pool),
                "K5b": lambda: conv1d.conv1d_pool_bwd(x, dy, idx, w, pool),
                "K6f": lambda: conv1d.conv1d_pool_ln_act(*ln),
                "K6b": lambda: conv1d.conv1d_pool_ln_act_bwd(
                    *ln[:6], idx6, stats, ypool, dy, *ln[6:])}
            plains = {
                "K5f": lambda: conv1d.conv1d_pool_ref(x, w, pool),
                "K5b": lambda: conv1d.conv1d_pool_bwd_ref(x, dy, idx, w,
                                                          pool),
                "K6f": lambda: conv1d.conv1d_pool_ln_act_ref(*ln),
                "K6b": lambda: conv1d.conv1d_pool_ln_act_bwd_ref(
                    *ln[:6], idx6, stats, dy, *ln[6:])}
            tag = f"N={N} L={L} K={K} O={O} pool={pool}"
            for name, fn in kernels.items():
                if shape in TIMED and before is not None:
                    t = []
                    for libs in (before, built, built, before):
                        with Use(libs):
                            t.append(median_ms(fn, 11))
                    print(f"time {name} {tag}: before {t[0]:.4f} {t[3]:.4f},"
                          f" as built {t[1]:.4f} {t[2]:.4f} ms (as built / "
                          f"before {(t[1] + t[2]) / (t[0] + t[3]):.3f})",
                          flush=True)
                else:
                    with Use(built):
                        t = [median_ms(fn, 11) for _ in range(2)]
                    print(f"time {name} {tag}: as built {t[0]:.4f} "
                          f"{t[1]:.4f} ms; plain {median_ms(plains[name], 3):.4f}"
                          f" ms", flush=True)
    print(f"{bad} shapes disagree", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
