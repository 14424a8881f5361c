#!/usr/bin/env python3
"""Smoke run of tpukaldi_torch on one NVIDIA card (H100), no JAX anywhere.

    python3 chip_smoke.py

Three TIMIT fMLLR recipes run at full width, 5x550 bidirectional with
batchnorm, recurrent dropout 0.2, two softmax heads (cd head 1944 pdfs)
and rmsprop: the flagship liGRU (cfg/TIMIT/liGRU_fmllr.cfg, relu), the LSTM
(LSTM_fmllr.cfg, tanh) and the GRU (GRU_fmllr.cfg, tanh).

1. Builds the port's six CUDA kernels (tpukaldi_torch/kernels/csrc/
   {ligru,lstm,gru}_{fwd,bwd}.cu), one nvcc per source, all at once, for
   sm_90a into build/tpukaldi_torch/.
2. Kernel phase, each kernel against its plain PyTorch version on the card:
   the forward recurrences (K1f liGRU, K2f LSTM, K3f GRU) at (T=778,
   B=64, H=550), the forward batch of 32 doubled by the bidirectional
   flip-concat, and (1000, 16, 550); the backward recurrences (K1b, K2b,
   K3b) at (778, 16, 550) and (1000, 16, 550), the training batch of 8
   doubled, at the longest utterance and at max_seq_length_train: error of
   h (and the LSTM's c), of dff, dmask and the weight gradients, and median
   time of each; and autograd through each Function (forward kernel, then
   backward kernel) against autograd through its plain loop at a small
   shape.
3. Serving phase, per recipe: the production forward over a synthetic
   Kaldi tree in real formats (40-dim fMLLR, 192 test utterances of 150-778
   frames) through `run_experiment(device="cuda")`, from random final
   checkpoints made from a seed: the recipe's forward kernel 5 times per
   forward batch and no backward launch, 192 finite 1944-wide posterior
   matrices agreeing with the plain recurrence (`*_impl = scan`) and, for
   two utterances, with the CPU path.
4. Training phase, per recipe, the slice's main path: the cfg over the same
   tree (train 64 utterances of 150-778 frames, dev 16), with 2 epochs of 2
   train chunks and no sequence-length curriculum, through
   `run_experiment(device="cuda")`: train and valid chunks, new-bob,
   res.res, final checkpoints, then the forward stage.  It checks the
   ledger, the checkpoints and the two `ep=` lines, that the train loss
   fell, that the forward kernel ran 5 x (train + valid + forward batches)
   and the backward kernel 5 x train batches (the runtime's own counters),
   the arks, and two utterances against the CPU path.  The first train
   chunk runs once more through the plain recurrence for its frames/s, and
   one full-width train step at drop 0 holds the kernel path's loss and
   gradients, and the plain path's, to a float64 run.
5. Profile phase, per recipe: the serving path's forward stage and one warm
   train chunk again under torch.profiler: device busy time, idle share,
   top device ops and, for the train chunk, device time by layer.

Each path is driven with every kernel's counts set to 0 just before it and
read just after.  Any failed check raises, so the exit code is not 0.  The
last lines are the card's name and power limit, one JSON line with the
kernels, and the result line.  Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HIDDEN = 550
N_LAYERS = 5
N_PDFS = 1944  # TIMIT's tri3 cd states
N_PHONES = 48
FWD_SHAPES = ((778, 64, HIDDEN), (1000, 16, HIDDEN))
BWD_SHAPES = ((778, 16, HIDDEN), (1000, 16, HIDDEN))
# kernel vs plain version on the card: both float32, the recurrent products
# summed in another order per step, compounding over up to 1000 steps
KERNEL_ATOL = 1e-4
# the backward kernels' dff and dmask as the forward's h; the weight
# gradients sum T*B = 16,000 rows in their own blocked order (the plain
# version in cuBLAS tiles), so they are held relative to their max, as h is
# (values of order 1)
DU_RTOL = 1e-4
# whole-path posteriors (log-probabilities minus log-priors, order 10):
# five such layers, batchnorm and a 1944-way log-softmax on each side
POSTERIOR_ATOL = 1e-3
# one full-width train step, kernel path vs plain path, both float32: the
# loss to 1e-4 absolute (order 10).  Their gradients pass back through five
# recurrences of hundreds of steps, where float32 rounding grows with the
# chain, so each path is held to a float64 run of the plain path: the kernel
# path's worst error (max |g - g64| / max |g64| over the tensors) may be at
# most STEP_GRAD_FACTOR times the plain float32 path's, i.e. as accurate as
# PyTorch's own float32 path up to the spread between two float32 sum
# orders
STEP_LOSS_ATOL = 1e-4
STEP_GRAD_FACTOR = 2.0
TRAIN_CUTS = {
    "n_epochs_tr = 24": "n_epochs_tr = 2",
    "increase_seq_length_train = True": "increase_seq_length_train = False",
    "n_chunks = 5": "n_chunks = 2",  # the train set's; dev and test keep 1
}
# recurrent class -> its kernel module
RECIPES = {"liGRU": "ligru", "LSTM": "lstm", "GRU": "gru"}
GRU_ACT = "tanh"  # the GRU recipe's activation


def _scan(recipe):
    """cfg replacements that run the recipe's plain recurrence: the liGRU
    cfg has an `ligru_impl` line; the LSTM and GRU cfgs have none, so the
    line is added."""
    p = recipe.lower()
    if recipe == "liGRU":
        return {"ligru_impl = auto": "ligru_impl = scan"}
    return {f"{p}_orthinit = True": f"{p}_orthinit = True\n{p}_impl = scan"}


def _no_drop(recipe):
    p = recipe.lower()
    return {f"{p}_drop = 0.2,0.2,0.2,0.2,0.2": f"{p}_drop = 0.0,0.0,0.0,0.0,0.0"}


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


def _recurrence_inputs(cell, T, B, H, seed):
    """ff (T, B, G*H), the cell's recurrent weights (orthogonal (H, H)
    blocks), a train-style mask and a gradient of h, on the card."""
    n_gates = {"ligru": 2, "lstm": 4, "gru": 3}[cell]
    g = torch.Generator().manual_seed(seed)
    ff = torch.randn(T, B, n_gates * H, generator=g)
    blocks = [torch.nn.init.orthogonal_(torch.empty(H, H), generator=g)
              for _ in range(n_gates)]
    mask = (torch.rand(B, H, generator=g) < 0.8).float()
    grad = torch.randn(T, B, H, generator=g) * 0.01
    # the GRU's Uzr = [Uz | Ur] and, apart, Uh
    ws = ((torch.cat(blocks[:2], dim=1), blocks[2]) if cell == "gru"
          else (torch.cat(blocks, dim=1),))
    return ff.cuda(), tuple(w.cuda() for w in ws), mask.cuda(), grad.cuda()


def _cell_fns(cell, mod, act=None):
    """Uniform entries of one cell's kernels and their plain versions:
    fwd(ff, ws, mask) -> (h[, c]); bwd(ff, outs, grad, ws, mask) -> (dff,
    weight gradients..., dmask); and the Function and its plain loop,
    (ff, *ws, mask) -> h."""
    if cell == "gru":
        act = act or GRU_ACT
        return dict(
            fwd=lambda ff, ws, m: (mod.gru_recurrence(ff, *ws, m, act),),
            fwd_ref=lambda ff, ws, m: (mod.gru_recurrence_ref(ff, *ws, m, act),),
            bwd=lambda ff, outs, g, ws, m: mod.gru_recurrence_bwd(
                ff, *outs, g, *ws, m, act),
            bwd_ref=lambda ff, outs, g, ws, m: mod.gru_recurrence_bwd_ref(
                ff, *outs, g, *ws, m, act),
            fn=lambda *a: mod.GRURecurrence.apply(*a, act),
            loop=lambda *a: mod.gru_recurrence_ref(*a, act),
            grads=("dff", "duzr", "duh", "dmask"))
    if cell == "lstm":
        return dict(
            fwd=lambda ff, ws, m: mod.lstm_recurrence(ff, *ws, m),
            fwd_ref=lambda ff, ws, m: mod.lstm_recurrence_ref(ff, *ws, m),
            bwd=lambda ff, outs, g, ws, m: mod.lstm_recurrence_bwd(
                ff, *outs, g, *ws, m),
            bwd_ref=lambda ff, outs, g, ws, m: mod.lstm_recurrence_bwd_ref(
                ff, *outs, g, *ws, m),
            fn=mod.LSTMRecurrence.apply,
            loop=lambda *a: mod.lstm_recurrence_ref(*a)[0],
            grads=("dff", "du", "dmask"))
    return dict(
        fwd=lambda ff, ws, m: (mod.ligru_recurrence(ff, *ws, m),),
        fwd_ref=lambda ff, ws, m: (mod.ligru_recurrence_ref(ff, *ws, m),),
        bwd=lambda ff, outs, g, ws, m: mod.ligru_recurrence_bwd(
            ff, *outs, g, *ws, m),
        bwd_ref=lambda ff, outs, g, ws, m: mod.ligru_recurrence_bwd_ref(
            ff, *outs, g, *ws, m),
        fn=mod.LiGRURecurrence.apply, loop=mod.ligru_recurrence_ref,
        grads=("dff", "du", "dmask"))


def kernel_phase(mods) -> dict:
    """Every kernel against its plain version at the main paths' shapes;
    returns {kernel name: worst error} and {(kernel name, T, B, H): (ms,
    plain ms)}."""
    errs, timing = {}, {}
    for cell, mod in mods.items():
        fns = _cell_fns(cell, mod)
        name = f"{cell}_fwd"
        for T, B, H in FWD_SHAPES:
            ff, ws, mask, _ = _recurrence_inputs(cell, T, B, H, T + B)
            with torch.inference_mode():
                got = fns["fwd"](ff, ws, mask)
                want = fns["fwd_ref"](ff, ws, mask)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                rel = err / max(b.abs().max().item() for b in want)
                ms = median_ms(lambda: fns["fwd"](ff, ws, mask), 5)
                plain_ms = median_ms(lambda: fns["fwd_ref"](ff, ws, mask), 3)
            print(f"kernel {name} T={T} B={B} H={H}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} (atol {KERNEL_ATOL:g}) "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            check(math.isfinite(err) and err <= KERNEL_ATOL,
                  f"{name} disagrees with its plain version at {(T, B, H)}: {err}")
            errs[name] = max(errs.get(name, 0.0), err)
            timing[(name, T, B, H)] = (ms, plain_ms)

        name = f"{cell}_bwd"
        for T, B, H in BWD_SHAPES:
            ff, ws, mask, grad = _recurrence_inputs(cell, T, B, H, T * B)
            with torch.inference_mode():
                outs = fns["fwd"](ff, ws, mask)
                got = fns["bwd"](ff, outs, grad, ws, mask)
                want = fns["bwd_ref"](ff, outs, grad, ws, mask)
                torch.cuda.synchronize()
                e = {n: (a - b).abs().max().item()
                     for n, a, b in zip(fns["grads"], got, want)}
                du_max = {n: b.abs().max().item()
                          for n, b in zip(fns["grads"], want) if n.startswith("du")}
                ms = median_ms(lambda: fns["bwd"](ff, outs, grad, ws, mask), 5)
                plain_ms = median_ms(
                    lambda: fns["bwd_ref"](ff, outs, grad, ws, mask), 3)
            print(f"kernel {name} T={T} B={B} H={H}: max_abs_err dff="
                  f"{e['dff']:.3e} dmask={e['dmask']:.3e} (atol "
                  f"{KERNEL_ATOL:g}), " + ", ".join(
                      f"{n}={e[n]:.3e} of max|{n}| {du_max[n]:.3f}"
                      for n in du_max)
                  + f" (rtol {DU_RTOL:g}); kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms", flush=True)
            check(all(math.isfinite(v) for v in e.values()),
                  f"{name}: non-finite error at {(T, B, H)}")
            check(e["dff"] <= KERNEL_ATOL and e["dmask"] <= KERNEL_ATOL,
                  f"{name} dff/dmask disagree at {(T, B, H)}: {e}")
            for n, mx in du_max.items():
                check(e[n] <= DU_RTOL * mx,
                      f"{name} {n} disagrees at {(T, B, H)}: {e[n]} of {mx}")
            errs[name] = max(errs.get(name, 0.0), *e.values())
            timing[(name, T, B, H)] = (ms, plain_ms)

        # autograd through the Function (forward kernel, then backward
        # kernel) against autograd through the plain loop, at a small shape;
        # 1e-5: float32, sums in other orders.  The GRU in both activations.
        for act in (("relu", "tanh") if cell == "gru" else (None,)):
            f = _cell_fns(cell, mod, act)
            ff, ws, mask, grad = _recurrence_inputs(cell, 50, 4, 64, 7)
            grads = []
            for fn in (f["fn"], f["loop"]):
                leaves = [x.clone().requires_grad_() for x in (ff, *ws)]
                (fn(*leaves, mask) * grad).sum().backward()
                grads.append([x.grad for x in leaves])
            torch.cuda.synchronize()
            ag_err = max((x - y).abs().max().item() for x, y in zip(*grads))
            label = f"{cell}" + (f" {act}" if act else "")
            print(f"kernel autograd ({label} Function vs plain loop, T=50 B=4 "
                  f"H=64): max_abs_err={ag_err:.3e} (atol 1e-5)", flush=True)
            check(ag_err <= 1e-5, f"{label} Function gradients disagree: {ag_err}")
    return {"errs": errs, "timing": timing}


def _reset_counts(mods, chunk_runtime) -> None:
    for mod in mods.values():
        mod.launches = mod.bwd_launches = 0
    chunk_runtime.train_batches = chunk_runtime.valid_batches = 0
    chunk_runtime.forward_batches = 0


def _counts(mods):
    return {cell: (mod.launches, mod.bwd_launches) for cell, mod in mods.items()}


def _check_only(counts, cell, what):
    """No kernel of another cell launched in a path of `cell`'s recipe."""
    others = {c: n for c, n in counts.items() if c != cell and any(n)}
    check(not others, f"{what}: kernels of other cells launched: {others}")


def _check_arks(posts, n_utts):
    names, lengths = [], []
    for key, post in posts:
        check(post.ndim == 2 and post.shape[1] == N_PDFS,
              f"{key}: posterior shape {post.shape}, expected (T, {N_PDFS})")
        check(bool(np.isfinite(post).all()), f"{key}: non-finite")
        names.append(key)
        lengths.append(post.shape[0])
    check(len(names) == n_utts, f"{len(names)} posterior matrices, expected {n_utts}")
    return names, lengths


def _check_cpu_path(ft, exp, out, names, lengths) -> float:
    """Two utterances (shortest, longest) through the port's CPU path from
    the same final checkpoints."""
    wanted = {names[lengths.index(min(lengths))],
              names[lengths.index(max(lengths))]}
    cpu = ft.forward_utterances(exp, sorted(wanted), "cpu")
    posts, _ = ft.forward_outputs(out)
    worst = max(float(abs(cpu[key] - post).max())
                for key, post in posts if key in wanted)
    check(worst <= POSTERIOR_ATOL,
          f"CUDA posteriors differ from the CPU path by {worst}")
    return worst


def _phases(info) -> str:
    return " ".join(f"{k[6:]}={v:.3f}" for k, v in info.items()
                    if k.startswith("phase_"))


def serving_phase(mods, tree, recipe) -> dict:
    """The serving path of one recipe: production forward from seeded final
    checkpoints."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    cell = RECIPES[recipe]
    out = os.path.join(WORK, f"serve_{recipe}")
    out_plain = os.path.join(WORK, f"serve_{recipe}_plain")
    for d in (out, out_plain):
        os.makedirs(d)
    src = ft.recipe_cfg(recipe)
    cfg = ft.write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), recipe=src)
    cfg_plain = ft.write_prod_cfg(tree, out_plain,
                                  os.path.join(out_plain, "run.cfg"),
                                  _scan(recipe), recipe=src)
    # the same seed, so both runs read the same weights
    ft.save_seeded_finals(cfg, dim=40)
    ft.save_seeded_finals(cfg_plain, dim=40)

    _reset_counts(mods, chunk_runtime)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts, n_batches = _counts(mods), chunk_runtime.forward_batches
    launches, bwd = counts[cell]
    _check_only(counts, cell, f"{recipe} serving")
    posts, info = ft.forward_outputs(out)

    _reset_counts(mods, chunk_runtime)
    t0 = time.perf_counter()
    run_experiment(cfg_plain, device="cuda")
    wall_plain = time.perf_counter() - t0
    check(not any(any(n) for n in _counts(mods).values()),
          f"{recipe} *_impl=scan still launched a kernel: {_counts(mods)}")
    posts_plain, info_plain = ft.forward_outputs(out_plain)

    posts, posts_plain = list(posts), list(posts_plain)
    names, lengths = _check_arks(posts, 192)
    worst_plain = 0.0
    for (key, post), (key_p, post_p) in zip(posts, posts_plain):
        check(key == key_p, f"ark order differs: {key} vs {key_p}")
        worst_plain = max(worst_plain, float(abs(post - post_p).max()))
    check(worst_plain <= POSTERIOR_ATOL,
          f"{recipe}: kernel path vs plain path posteriors differ by {worst_plain}")
    # every forward batch ran its 5 layers through the kernel; 192
    # utterances in batches of at most 32 take at least 6 batches
    fwd_bs = int(os.environ.get("TPUKALDI_FORWARD_BATCH", "32"))
    check(n_batches >= math.ceil(len(names) / fwd_bs),
          f"{n_batches} forward batches for {len(names)} utterances")
    check(launches == N_LAYERS * n_batches and bwd == 0,
          f"{cell} kernels launched {launches} (fwd), {bwd} (bwd) times, "
          f"expected {N_LAYERS} x {n_batches} forward batches and 0")
    frames = int(sum(lengths))
    check(int(info["frames"]) == frames, f".info frames {info['frames']} != {frames}")
    worst_cpu = _check_cpu_path(ft, exp, out, names, lengths)

    print(f"serving {recipe}: 192 utterances, {frames} frames, {n_batches} "
          f"forward batches of up to {fwd_bs}, {cell}_fwd launches {launches} "
          f"(= {N_LAYERS} x {n_batches}), arks {N_PDFS} wide, all finite",
          flush=True)
    print(f"serving {recipe} kernel path: forward stage "
          f"{info['elapsed_time_chunk']:.3f} s, {info['frames_per_sec']:.1f} "
          f"frames/s (.info), run_experiment wall {wall:.3f} s, phases "
          f"{_phases(info)}", flush=True)
    print(f"serving {recipe} plain path ({cell}_impl=scan): forward stage "
          f"{info_plain['elapsed_time_chunk']:.3f} s, "
          f"{info_plain['frames_per_sec']:.1f} frames/s (.info), run_experiment "
          f"wall {wall_plain:.3f} s, phases {_phases(info_plain)}", flush=True)
    print(f"serving {recipe} agreement: kernel vs plain path max_abs_err="
          f"{worst_plain:.3e}, CUDA vs CPU path (2 utterances) max_abs_err="
          f"{worst_cpu:.3e} (atol {POSTERIOR_ATOL:g})", flush=True)
    return {"cfg": cfg}


def _train_infos(out):
    ef = os.path.join(out, "exp_files")
    return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
            if f.endswith(".info") and f.startswith(("train_", "valid_"))}


def train_phase(mods, tree, recipe) -> dict:
    """The main path of one recipe: full-width training, then forward."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    cell = RECIPES[recipe]
    src = ft.recipe_cfg(recipe)
    out = os.path.join(WORK, f"train_{recipe}")
    out_plain = os.path.join(WORK, f"train_{recipe}_plain")
    for d in (out, out_plain):
        os.makedirs(d)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             TRAIN_CUTS, recipe=src)
    cfg_plain = ft.write_train_cfg(tree, out_plain,
                                   os.path.join(out_plain, "run.cfg"),
                                   {**TRAIN_CUTS, **_scan(recipe)}, recipe=src)

    # the main path, counted
    _reset_counts(mods, chunk_runtime)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts(mods)
    launches, bwd = counts[cell]
    _check_only(counts, cell, f"{recipe} training")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)

    # the ledger: 2 epochs x (2 train chunks + 1 valid chunk)
    infos = _train_infos(out)
    check(len(infos) == 6, f"train/valid .info files: {sorted(infos)}")
    values = {f: chunk_runtime.read_info(p) for f, p in infos.items()}
    for f, v in values.items():
        check(math.isfinite(v["loss"]) and math.isfinite(v["err"])
              and v["frames"] > 0, f"{f}: {v}")
    _, plan = ft.train_plan(cfg)
    for ep_plan in plan.epochs:
        for task in ep_plan.tasks:
            for path in task.ckpt_files.values():
                check(os.path.exists(path), f"missing checkpoint {path}")
    for path in plan.final_ckpts.values():
        check(os.path.exists(path), f"missing final checkpoint {path}")
    with open(os.path.join(out, "res.res")) as f:
        res = f.read().splitlines()
    ep_lines = [line for line in res if line.startswith("ep=")]
    check(len(ep_lines) == 2, f"res.res ep= lines: {ep_lines}")
    tr_loss = [float(line.split(" loss=")[1].split()[0]) for line in ep_lines]
    check(tr_loss[1] < tr_loss[0], f"{recipe} train loss did not fall: {tr_loss}")

    # the forward kernel ran in every layer of every batch, the backward
    # kernel in every train batch
    check(n_train == 2 * 2 * 32 // 8, f"{n_train} train batches, expected 16")
    check(launches == N_LAYERS * (n_train + n_valid + n_fwd),
          f"{cell}_fwd launched {launches} times, expected {N_LAYERS} x "
          f"({n_train} train + {n_valid} valid + {n_fwd} forward batches)")
    check(bwd == N_LAYERS * n_train,
          f"{cell}_bwd launched {bwd} times, expected {N_LAYERS} x {n_train}")

    posts, _ = ft.forward_outputs(out)
    names, lengths = _check_arks(list(posts), 192)
    worst_cpu = _check_cpu_path(ft, exp, out, names, lengths)

    print(f"training {recipe}: 2 epochs, {n_train} train + {n_valid} valid + "
          f"{n_fwd} forward batches; {cell}_fwd launches {launches} (= "
          f"{N_LAYERS} x {n_train + n_valid + n_fwd}), {cell}_bwd launches "
          f"{bwd} (= {N_LAYERS} x {n_train}); run_experiment wall {wall:.3f} s",
          flush=True)
    for line in res:
        print(f"training {recipe} res.res: {line}", flush=True)
    for f, v in values.items():
        print(f"training {recipe} .info {f}: loss={v['loss']:.4f} "
              f"err={v['err']:.4f} frames={int(v['frames'])} "
              f"{v['frames_per_sec']:.1f} frames/s, phases {_phases(v)}",
              flush=True)
    print(f"training {recipe} arks: 192 finite, {N_PDFS} wide; CUDA vs CPU "
          f"path (2 utterances) max_abs_err={worst_cpu:.3e} (atol "
          f"{POSTERIOR_ATOL:g})", flush=True)

    # the plain recurrence on the first train chunk only
    exp_plain, plan_plain = ft.train_plan(cfg_plain)
    task = plan_plain.epochs[0].tasks[0]
    rt = chunk_runtime.ChunkRuntime(exp_plain, "cuda")
    _reset_counts(mods, chunk_runtime)
    plain = rt.run_task(task, epoch_lr={a: s.lr[0] for a, s in exp_plain.archs.items()},
                        batch_size=exp_plain.batches.batch_size_train[0])
    check(not any(any(n) for n in _counts(mods).values()),
          f"{cell}_impl=scan launched a kernel: {_counts(mods)}")
    first = values[os.path.basename(task.info_file)]
    print(f"training {recipe} first train chunk: kernel path "
          f"{first['frames_per_sec']:.1f} frames/s, plain path ({cell}_impl="
          f"scan) {plain.frames_per_sec:.1f} frames/s (.info); loss "
          f"{first['loss']:.6f} vs {plain.loss:.6f} (the same dropout draws)",
          flush=True)

    step_check(tree, recipe)
    return {"launches": launches, "bwd_launches": bwd, "cfg": cfg}


def step_check(tree, recipe) -> None:
    """One full-width train step of the recipe at drop 0: the kernel path's
    loss and gradients, and the plain path's, held to a float64 run of the
    plain path."""
    from tpukaldi_torch.tools import flagship_tree as ft

    src = ft.recipe_cfg(recipe)
    out_step = os.path.join(WORK, f"train_{recipe}_step")
    os.makedirs(out_step, exist_ok=True)
    cfg_k = ft.write_train_cfg(tree, out_step, os.path.join(out_step, "k.cfg"),
                               {**TRAIN_CUTS, **_no_drop(recipe)}, recipe=src)
    cfg_s = ft.write_train_cfg(tree, out_step, os.path.join(out_step, "s.cfg"),
                               {**TRAIN_CUTS, **_no_drop(recipe),
                                **_scan(recipe)}, recipe=src)
    loss_k, grads_k, shape = ft.train_step_gradients(cfg_k, "cuda")
    loss_s, grads_s, _ = ft.train_step_gradients(cfg_s, "cuda")
    loss_r, grads_r, _ = ft.train_step_gradients(cfg_s, "cuda", torch.float64)

    def worst(grads, ref):
        """(max over tensors of max|g - ref| / max|ref|, that tensor)"""
        rel = {name: ((g.double() - ref[name].double()).abs().max()
                      / ref[name].double().abs().max().clamp_min(1e-30)).item()
               for name, g in grads.items()}
        name = max(rel, key=rel.get)
        check(all(math.isfinite(r) for r in rel.values()),
              "non-finite gradient error")
        return rel[name], name

    err_k, name_k = worst(grads_k, grads_r)
    err_s, name_s = worst(grads_s, grads_r)
    err_ks, name_ks = worst(grads_k, grads_s)
    loss_err = abs(loss_k - loss_s)
    print(f"training {recipe} step at drop 0 (batch {tuple(shape)}, "
          f"{len(grads_k)} gradients): loss kernel {loss_k:.7f} plain "
          f"{loss_s:.7f} float64 {loss_r:.7f}, kernel vs plain |diff|="
          f"{loss_err:.3e} (atol {STEP_LOSS_ATOL:g}); worst gradient error vs "
          f"float64: kernel path {err_k:.3e} ({name_k}), plain float32 path "
          f"{err_s:.3e} ({name_s}) (factor {STEP_GRAD_FACTOR:g}); kernel vs "
          f"plain {err_ks:.3e} ({name_ks})", flush=True)
    check(loss_err <= STEP_LOSS_ATOL,
          f"{recipe} train step loss differs by {loss_err}")
    check(err_k <= STEP_GRAD_FACTOR * err_s,
          f"{recipe} kernel path gradients {err_k} from float64, plain path {err_s}")


def _device_events(prof):
    from torch.autograd import DeviceType

    # device kernels and copies; not the device-side spans of annotations
    # such as `Optimizer.step#RMSprop.step`, which cover kernels counted too
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    check(bool(events), "the profiler recorded no device events")
    busy_us, last = 0.0, -math.inf
    per_op = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, last))
        last = max(last, e.time_range.end)
        n, us = per_op.get(e.name, (0, 0.0))
        per_op[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return busy_us, per_op


def _print_profile(label, wall, busy_us, per_op, n_top=3):
    busy = busy_us / 1e6
    print(f"profile {label}: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    for name, (n, us) in sorted(per_op.items(), key=lambda kv: -kv[1][1])[:n_top]:
        print(f"profile {label} device op: {us / 1e3:.1f} ms ({us / busy_us:.1%} "
              f"of busy) x{n} {name[:70]}", flush=True)


# device-op name patterns -> training layer, first match wins (so the
# liGRU's names come before the GRU's, which they contain); GEMMs of the FF
# projections, the heads and their backward share cuBLAS kernel names
LAYERS = (
    ("K1f", ("ligru_fwd_kernel",)),
    ("K1b sequential", ("ligru_bwd_seq_kernel",)),
    ("K2f", ("lstm_fwd_kernel",)),
    ("K2b sequential", ("lstm_bwd_seq_kernel",)),
    ("K3f", ("gru_fwd_kernel",)),
    ("K3b sequential", ("gru_bwd_seq_kernel",)),
    ("dU passes (K1b, K2b, K3b)", ("du_tile_kernel",)),
    ("GEMM (FF, heads, their backward)", ("gemm", "Gemm", "cutlass", "xmma",
                                          "sm90_", "splitKreduce")),
    ("batchnorm", ("batch_norm", "batchnorm", "welford", "bn_")),
    ("optimizer (rmsprop, foreach)", ("multi_tensor_apply", "foreach")),
    ("dropout draws", ("bernoulli", "philox", "distribution")),
    ("H2D copy", ("Memcpy HtoD",)),
    ("D2H copy", ("Memcpy DtoH",)),
)


def _by_layer(per_op):
    out = {}
    for name, (n, us) in per_op.items():
        layer = next((lab for lab, pats in LAYERS
                      if any(p in name for p in pats)), "elementwise, reductions, other")
        out[layer] = out.get(layer, 0.0) + us
    return out


def profile_phase(recipe, serve_cfg: str, train_cfg: str) -> None:
    """One recipe's serving forward stage, and one warm train chunk, once
    more under torch.profiler.  Device busy time is the union of the
    device's kernel and copy intervals; the idle share is the rest of the
    wall time.  The full op tables go to build/chip_smoke/profile_*.txt."""
    from torch.profiler import ProfilerActivity, profile

    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    out = os.path.dirname(serve_cfg)
    ef = os.path.join(out, "exp_files")
    for f in os.listdir(ef):  # drop the forward ledger so the task runs again
        if f.startswith("forward_"):
            os.remove(os.path.join(ef, f))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_experiment(serve_cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, info = ft.forward_outputs(out)
    busy_us, per_op = _device_events(prof)
    _print_profile(f"{recipe} serving (warm run_experiment)", wall, busy_us, per_op)
    print(f"profile {recipe} serving: forward stage {info['frames_per_sec']:.1f} "
          "frames/s (.info)", flush=True)
    with open(os.path.join(WORK, f"profile_{recipe}_serving.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=-1))

    # a warm train chunk: epoch 1's first chunk runs (restoring epoch 0's
    # checkpoints) and the second, which continues from resident state as
    # every chunk after the first does, is profiled
    train_exp, plan = ft.train_plan(train_cfg)
    ep1 = [t for t in plan.epochs[1].tasks if t.phase == "train"]
    rt = ChunkRuntime(train_exp, "cuda")
    kw = dict(epoch_lr={a: s.lr[1] for a, s in train_exp.archs.items()},
              batch_size=train_exp.batches.batch_size_train[1])
    rt.run_task(ep1[0], **kw)
    chunk = rt.load_task_chunk(ep1[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = rt.run_task(ep1[1], chunk=chunk, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, per_op = _device_events(prof)
    label = f"{recipe} train chunk"
    _print_profile(f"{label} (warm)", wall, busy_us, per_op, n_top=5)
    print(f"profile {label}: {res.n_batches} steps, {res.frames} frames, "
          f"{res.frames_per_sec:.1f} frames/s (.info), phases " + " ".join(
              f"{k}={v:.3f}" for k, v in res.phases.items()), flush=True)
    for layer, us in sorted(_by_layer(per_op).items(), key=lambda kv: -kv[1]):
        print(f"profile {label} layer: {layer}: {us / 1e3:.1f} ms "
              f"({us / busy_us:.1%} of busy)", flush=True)
    with open(os.path.join(WORK, f"profile_{recipe}_train.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=-1))


def build_kernels(mods) -> None:
    """Every kernel source, one nvcc each, all at once."""
    from tpukaldi_torch.kernels import _build

    t0 = time.perf_counter()
    sources = [s for mod in mods.values() for s in (mod.SOURCE, mod.BWD_SOURCE)]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"build {', '.join(sources)} (nvcc sm_90a, in parallel): "
          f"{time.perf_counter() - t0:.2f} s -> "
          + ", ".join(os.path.relpath(lib, REPO) for lib in libs), flush=True)


def _timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpukaldi_torch.kernels import gru, ligru, lstm
    from tpukaldi_torch.tools import flagship_tree as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    mods = {"ligru": ligru, "lstm": lstm, "gru": gru}
    build_kernels(mods)

    # a process's first torch.optim optimizer imports torch._dynamo (seconds
    # of host time, once per process); done here, timed, so that no chunk
    # measured below carries it
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    print(f"import torch._dynamo (once per training process): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    k = _timed("kernels", kernel_phase, mods)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    tree = ft.write_kaldi_tree(
        os.path.join(WORK, "tree"), dim=40, n_phones=N_PHONES, n_pdfs=N_PDFS,
        splits={"train": (64, 150, 778), "dev": (16, 150, 778),
                "test": (192, 150, 778)})
    print(f"synthetic tree: {time.perf_counter() - t0:.1f} s", flush=True)
    trained = {}
    for recipe in RECIPES:
        s = _timed(f"{recipe} serving", serving_phase, mods, tree, recipe)
        trained[recipe] = _timed(f"{recipe} training", train_phase, mods,
                                 tree, recipe)
        _timed(f"{recipe} profile", profile_phase, recipe, s["cfg"],
               trained[recipe]["cfg"])
    print(f"chip_smoke total (after the card check): "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # the Pallas kernel bodies each replaces
    replaces = {"ligru_fwd": "tpukaldi/kernels/ligru.py:41",
                "ligru_bwd": "tpukaldi/kernels/ligru.py:106",
                "lstm_fwd": "tpukaldi/kernels/lstm.py:43",
                "lstm_bwd": "tpukaldi/kernels/lstm.py:128",
                "gru_fwd": "tpukaldi/kernels/gru.py:49",
                "gru_bwd": "tpukaldi/kernels/gru.py:119"}
    kernels = []
    for recipe, cell in RECIPES.items():
        mod = mods[cell]
        for kind, source, shape, key in (
                ("fwd", mod.SOURCE, FWD_SHAPES[0], "launches"),
                ("bwd", mod.BWD_SOURCE, BWD_SHAPES[0], "bwd_launches")):
            name = f"{cell}_{kind}"
            ms, plain_ms = k["timing"][(name, *shape)]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"tpukaldi_torch/kernels/csrc/{source}",
                "replaces": replaces[name],
                "launches": trained[recipe][key],
                "max_abs_err": k["errs"][name], "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
