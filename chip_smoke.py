#!/usr/bin/env python3
"""Smoke run of tpukaldi_torch on one NVIDIA card (H100), no JAX anywhere.

    python3 chip_smoke.py

1. Builds the port's CUDA kernel (tpukaldi_torch/kernels/csrc/ligru_fwd.cu)
   with nvcc for sm_90a into build/tpukaldi_torch/.
2. Kernel phase: the liGRU forward recurrence against its plain PyTorch
   version on the card at the flagship's shapes — (T=778, B=64, H=550), the
   forward batch of 32 doubled by the bidirectional flip-concat, and
   (T=1000, B=16, H=550) — error and median time of each.
3. Slice phase: the flagship production forward (cfg/TIMIT/liGRU_fmllr.cfg at
   full width: 5x550 bidirectional liGRU with batchnorm, relu, recurrent
   dropout 0.2, two softmax heads; cd head 1944 pdfs) over a synthetic
   Kaldi tree in real formats (40-dim fMLLR, 192 test utterances of 150-778
   frames) through `tpukaldi_torch.tools.run_exp.run_experiment(device=
   "cuda")`, from random final checkpoints made from a seed.  It checks that
   the kernel ran 5 times per forward batch, that the 192 posterior
   matrices are finite and 1944 wide, and that they agree with the same
   run through the plain recurrence (`ligru_impl = scan`) and, for two
   utterances, with the port's CPU path.
4. Profile phase: the slice's kernel path once more, warm, under
   torch.profiler: the device's busy time, idle share and top ops.

Any failed check raises, so the exit code is not 0.  The last lines are the
card's name and power limit, one JSON line per kernel, and the result line.
Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HIDDEN = 550
N_LAYERS = 5
N_PDFS = 1944  # TIMIT's tri3 cd states
N_PHONES = 48
KERNEL_SHAPES = ((778, 64, HIDDEN), (1000, 16, HIDDEN))
# kernel vs plain version on the card: both float32, h @ U summed in another
# order per step, compounding over up to 1000 steps
KERNEL_ATOL = 1e-4
# whole-path posteriors (log-probabilities minus log-priors, order 10):
# five such layers, batchnorm and a 1944-way log-softmax on each side
POSTERIOR_ATOL = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps: int) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_phase(ligru) -> dict:
    worst = 0.0
    timing = {}
    for T, B, H in KERNEL_SHAPES:
        g = torch.Generator().manual_seed(T + B)
        ff = torch.randn(T, B, 2 * H, generator=g).cuda()
        u = torch.cat([torch.nn.init.orthogonal_(torch.empty(H, H), generator=g)
                       for _ in range(2)], dim=1).cuda()
        mask = (torch.rand(B, H, generator=g) < 0.8).float().cuda()
        with torch.inference_mode():
            got = ligru.ligru_recurrence(ff, u, mask)
            want = ligru.ligru_recurrence_ref(ff, u, mask)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = median_ms(lambda: ligru.ligru_recurrence(ff, u, mask), 5)
            plain_ms = median_ms(lambda: ligru.ligru_recurrence_ref(ff, u, mask), 3)
        print(f"kernel ligru_fwd T={T} B={B} H={H}: max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (atol {KERNEL_ATOL:g}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        check(math.isfinite(err) and err <= KERNEL_ATOL,
              f"ligru kernel disagrees with its plain version at {(T, B, H)}: {err}")
        worst = max(worst, err)
        timing[(T, B, H)] = (ms, plain_ms)
    ms, plain_ms = timing[KERNEL_SHAPES[0]]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def slice_phase(ligru) -> dict:
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    tree = ft.write_kaldi_tree(
        os.path.join(WORK, "tree"), dim=40, n_phones=N_PHONES, n_pdfs=N_PDFS,
        splits={"train": (24, 150, 400), "dev": (4, 150, 400),
                "test": (192, 150, 778)})
    out, out_plain = os.path.join(WORK, "out"), os.path.join(WORK, "out_plain")
    for d in (out, out_plain):
        os.makedirs(d)
    cfg = ft.write_prod_cfg(tree, out, os.path.join(out, "run.cfg"))
    cfg_plain = ft.write_prod_cfg(tree, out_plain, os.path.join(out_plain, "run.cfg"),
                                  {"ligru_impl = auto": "ligru_impl = scan"})
    # the same seed, so both runs read the same weights
    ft.save_seeded_finals(cfg, dim=40)
    ft.save_seeded_finals(cfg_plain, dim=40)
    print(f"slice setup (tree, cfg, seeded final checkpoints): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path, counted
    ligru.launches = 0
    chunk_runtime.forward_batches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches, n_batches = ligru.launches, chunk_runtime.forward_batches
    posts, info = ft.forward_outputs(out)

    ligru.launches = 0
    t0 = time.perf_counter()
    run_experiment(cfg_plain, device="cuda")
    wall_plain = time.perf_counter() - t0
    check(ligru.launches == 0, "ligru_impl=scan still launched the kernel")
    posts_plain, info_plain = ft.forward_outputs(out_plain)

    lengths, names, worst_plain = [], [], 0.0
    for (key, post), (key_p, post_p) in zip(posts, posts_plain):
        check(key == key_p, f"ark order differs: {key} vs {key_p}")
        check(post.ndim == 2 and post.shape[1] == N_PDFS,
              f"{key}: posterior shape {post.shape}, expected (T, {N_PDFS})")
        check(bool(np.isfinite(post).all()), f"{key}: non-finite")
        worst_plain = max(worst_plain, float(abs(post - post_p).max()))
        lengths.append(post.shape[0])
        names.append(key)
    check(len(names) == 192, f"{len(names)} posterior matrices, expected 192")
    check(worst_plain <= POSTERIOR_ATOL,
          f"kernel path vs plain path posteriors differ by {worst_plain}")

    # every forward batch ran its 5 liGRU layers through the kernel; 192
    # utterances in batches of at most 32 take at least 6 batches
    fwd_bs = int(os.environ.get("TPUKALDI_FORWARD_BATCH", "32"))
    check(n_batches >= math.ceil(len(names) / fwd_bs),
          f"{n_batches} forward batches for {len(names)} utterances")
    check(launches == N_LAYERS * n_batches,
          f"ligru kernel launched {launches} times, expected "
          f"{N_LAYERS} x {n_batches} forward batches")
    frames = int(sum(lengths))
    check(int(info["frames"]) == frames, f".info frames {info['frames']} != {frames}")

    # two utterances (shortest, longest) through the port's CPU path
    wanted = {names[lengths.index(min(lengths))], names[lengths.index(max(lengths))]}
    cpu = ft.forward_utterances(exp, sorted(wanted), "cpu")
    posts, _ = ft.forward_outputs(out)
    worst_cpu = max(float(abs(cpu[key] - post).max())
                    for key, post in posts if key in wanted)
    check(worst_cpu <= POSTERIOR_ATOL,
          f"CUDA posteriors differ from the CPU path by {worst_cpu}")

    print(f"slice: 192 utterances, {frames} frames, {n_batches} forward batches of "
          f"up to {fwd_bs}, ligru kernel launches {launches} "
          f"(= {N_LAYERS} x {n_batches}), arks {N_PDFS} wide, all finite", flush=True)
    print(f"slice kernel path: forward stage {info['elapsed_time_chunk']:.3f} s, "
          f"{info['frames_per_sec']:.1f} frames/s (.info), run_experiment wall "
          f"{wall:.3f} s, phases " + " ".join(
              f"{k[6:]}={v:.3f}" for k, v in info.items() if k.startswith("phase_")),
          flush=True)
    print(f"slice plain path (ligru_impl=scan): forward stage "
          f"{info_plain['elapsed_time_chunk']:.3f} s, "
          f"{info_plain['frames_per_sec']:.1f} frames/s (.info), run_experiment "
          f"wall {wall_plain:.3f} s, phases " + " ".join(
              f"{k[6:]}={v:.3f}" for k, v in info_plain.items()
              if k.startswith("phase_")), flush=True)
    print(f"slice agreement: kernel vs plain path max_abs_err={worst_plain:.3e}, "
          f"CUDA vs CPU path (2 utterances) max_abs_err={worst_cpu:.3e} "
          f"(atol {POSTERIOR_ATOL:g})", flush=True)
    return {"launches": launches, "cfg": cfg}


def profile_phase(cfg: str) -> None:
    """The kernel path's run_experiment once more, warm, under
    torch.profiler.  Device busy time is the union of the device's kernel
    and copy intervals; the idle share is the rest of the run's wall time.
    The full op table goes to build/chip_smoke/profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment

    out = os.path.dirname(cfg)
    ef = os.path.join(out, "exp_files")
    for f in os.listdir(ef):  # drop the forward ledger so the task runs again
        if f.startswith("forward_"):
            os.remove(os.path.join(ef, f))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_experiment(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, info = ft.forward_outputs(out)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device events")
    busy_us, last = 0.0, -math.inf
    per_op = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, last))
        last = max(last, e.time_range.end)
        n, us = per_op.get(e.name, (0, 0.0))
        per_op[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = busy_us / 1e6
    print(f"profile (kernel path, warm run_experiment): wall {wall:.3f} s, "
          f"device busy {busy:.3f} s, idle share {1 - busy / wall:.3f}; forward "
          f"stage {info['frames_per_sec']:.1f} frames/s (.info)", flush=True)
    # device-side kernels and copies only, so the shares do not overlap
    for name, (n, us) in sorted(per_op.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"profile device op: {us / 1e3:.1f} ms ({us / busy_us:.1%} of busy) "
              f"x{n} {name[:90]}", flush=True)
    with open(os.path.join(WORK, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=-1))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpukaldi_torch.kernels import _build, ligru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build(ligru.SOURCE)
    print(f"build ligru_fwd.cu (nvcc sm_90a): {time.perf_counter() - t0:.2f} s "
          f"-> {os.path.relpath(lib, REPO)}", flush=True)

    k = kernel_phase(ligru)
    s = slice_phase(ligru)
    profile_phase(s["cfg"])

    print(card)
    print(json.dumps({"kernels": [{
        "name": "ligru_fwd", "route": "cuda",
        "source": "tpukaldi_torch/kernels/csrc/ligru_fwd.cu",
        "replaces": "tpukaldi/kernels/ligru.py:41",
        "launches": s["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
