#!/usr/bin/env python3
"""Smoke run of tpukaldi_torch on one NVIDIA card (H100), no JAX anywhere.

    python3 chip_smoke.py

Six recipes run at full width, and the rest of the zoo in a phase of its
own (9 below).  Three TIMIT fMLLR recipes, 5x550
bidirectional with batchnorm, recurrent dropout 0.2, two softmax heads (cd
head 1944 pdfs) and rmsprop: the flagship liGRU (cfg/TIMIT/liGRU_fmllr.cfg,
relu), the LSTM (LSTM_fmllr.cfg, tanh) and the GRU (GRU_fmllr.cfg, tanh).
The DIRHA QLSTM (cfg/DIRHA/QLSTM_mfcc.cfg): 2x1024 bidirectional
quaternion LSTM, tanh, recurrent dropout 0.2, the lean quaternion backward
(`autograd = False`), one softmax head, rmsprop, batch 16, whose recurrence
runs the bf16-U kernels.  And the TIMIT raw-waveform recipes over 3200-sample
windows, batch 128, each with an MLP 2048,2048,1944 (batchnorm,
leaky_relu, softmax): CNN_raw.cfg (convs 128,60,60,60, layer norm, relu,
dropout 0.15, rmsprop), whose layer 0 runs the fused conv, pool, layer
norm, relu and dropout kernels (K6f/K6b), and SincNet_raw.cfg (sinc convs
80,60,60, leaky_relu, sgd), whose layer 0 runs the conv + pool kernels
(K5f/K5b).

1. Builds the port's fourteen CUDA kernels (tpukaldi_torch/kernels/csrc/
   {ligru,lstm,gru,lstm_lean}_{fwd,bwd}.cu, conv_pool_{fwd,bwd}.cu,
   conv_ln_{fwd,bwd}.cu and conv_stack_{fwd,bwd}.cu), one nvcc per source,
   all at once, for sm_90a into build/tpukaldi_torch/, and prints each
   kernel's registers and spills from ptxas's report.  The port's
   `resolve_device("cuda")` pins float32 (cuDNN's TF32 off) first; this
   script sets no precision flag itself.
2. Kernel phase, each kernel against its plain PyTorch version on the card:
   the forward recurrences (K1f liGRU, K2f LSTM, K3f GRU) at (T=778,
   B=64, H=550), the forward batch of 32 doubled by the bidirectional
   flip-concat, and (1000, 16, 550); the backward recurrences (K1b, K2b,
   K3b) at (778, 16, 550) and (1000, 16, 550), the training batch of 8
   doubled, at the longest utterance and at max_seq_length_train; the
   bf16-U LSTM (K4f, K4b) at the QLSTM's shapes, (778, 64, 1024) and
   (1000, 32, 1024) forward, (778, 32, 1024) and (1000, 32, 1024)
   backward: error of h (and the LSTMs' c), of dff, dmask and the weight
   gradients, and median time of each; and autograd through each Function
   (forward kernel, then backward kernel) against its plain versions at a
   small shape.  K4f, K1f, K2f, K3f and the sequential passes of K1b, K2b,
   K3b and K4b are each one persistent cooperative launch with U resident
   in shared memory (K4f, K4b: bf16 tensor-core products; K1f, K2f, K3f,
   K1b, K2b, K3b: float32 FMAs; K1b, K2b, K3b and K4b also run a parallel
   gate remat before it, and dU passes after it, K4b's the float32 GEMM,
   timed alone too; K1b's chain streams dA, K3f exchanges h and r * h, K3b's
   chain partial sums, twice a step).
   K4f is also held, step by step, to one plain step from its own previous
   state, and run at the edges of its tiling, (37, 5, 36) and (50, 96,
   1024), under the same tolerances; K1f, K2f, K3f, K1b, K2b and K3b at (37,
   5, 36), (50, 136, 550) (two passes) and (50, 96, 1024), K3f and K3b in tanh
   (the recipe's) and also in relu, K3f at (778, 64, 550), K3b at (778,
   16, 550); K4b at (37, 5, 36), (50, 96, 1024) and (50, 136, 1024) (two
   passes).  All eight are called twice on the same inputs (bitwise equal),
   and their us per step, grid (CTAs, units each), shared memory a CTA and
   chunk width (K2b, K3b, K4b: the producers' partial sums staged at a
   time, and the partial-sum buffers; K1b: the units' dA pairs staged at a
   time, and the dA buffer) are printed beside the time.  K4f
   and K4b are timed beside the float32 K2f and K2b on the same inputs,
   K3b beside K2b at the same (T, B, H).  The four forwards also past the
   backwards' limit, at WIDE_FWD_SHAPES (H = 2048 at the flagship's
   serving batch and at 64 rows, 1036 and 1536; K3f in tanh and relu, K4f
   through its float32-ff and bf16-ff entries), under the same checks,
   each with the rows of U a CTA keeps resident and the bytes of U the
   grid streams a step (csrc/u_stream.cuh), its time and its bound (which
   counts the share of U past all the card's shared memory once a step,
   from L2 at the rate this run measures with csrc/l2_read.cu before the
   kernel phase), and cuDNN's float32 and bf16 LSTM beside K2f and K4f at
   (778, 16, 2048).
   The conv kernels (K5f, K5b, K6f, K6b) at
   the training batch (128, 3200, K=129, O=80 and 128, pool 3), K6 also
   at dropout 0.15 (the same dropped elements), at an odd shape, and K5f
   and K6f on the serving batch of 32,000 windows (a slice held to the
   plain version); the backwards given the kernel's own argmax (K6b its
   own ypool, the pooled value K6f keeps in training), with dX and without
   (`need_dx=False`, for a layer 0 whose input needs no gradient): their
   other gradients bitwise equal between the two, and two calls bitwise
   equal.  K6 also at cfg/TIMIT/CNN_fbank.cfg's layer 0 (L=440,
   K=10, O=80, pool 3, drop 0.15).  All four the same way at SincNet's
   published 251 taps (CONV_251: K5 at O=80, K6 at 128, also at drop
   0.15), timed with their bounds and yardsticks (`k251_*` on their
   records), and at a pool of 16 (CONV_LONG_POOL), past the forwards' run
   of 12 conv positions.  K5f and K6f also at forced ties (x
   and w in {-1, 0, 1}: the argmax exactly the plain version's) and on
   their launch's other paths (row blocks, one pooled-row buffer).  Beside each kernel: the least time the card could take for the
   same work (bytes or operations, at the published peaks), and a library
   yardstick the port never calls: cuDNN's LSTM at mask 1 for K2f and K4f
   (float32, bf16) and its backward for K2b and K4b (input and recurrent
   weight gradients, its input gradient held beside the kernel's dff),
   F.conv1d + F.max_pool1d (+ the layer norm and relu as PyTorch ops, and
   their autograd backward) for the conv kernels.
   The whole conv stack (`conv_stack_fused`, which no recipe calls: its
   own entry point is its path) at CNN_raw's stack shapes (filters
   128,60,60,60, K 129,5,5,3, pools 3,3,3,2 over 3200 samples): K7f and
   K7b against their plain versions at the training batch of 128 windows,
   at drop 0 and 0.15: every layer's output, stats and kept pooled value,
   the argmax but at near-ties, the same dropped elements; K7b given the
   kernel's own residuals, and normwise against the plain backward on the
   plain forward's, two calls bitwise equal; K7f at drop 0 against the port's per-layer path (`CNN`
   at TPUKALDI_CONV_IMPL=pallas), whose forward and autograd backward are
   the yardstick; K7f on the serving batch with its peak memory beside the
   per-layer path's; then the stack's path, counted: three training steps
   through `conv_stack_fused` with dropout and one forward.
3. Serving phase, per recipe: the production forward over a synthetic
   Kaldi tree in real formats (40-dim fMLLR or mfcc, 192 test utterances
   of 150-778 frames; the raw tree 48 of 3200-sample windows per frame)
   through `run_experiment(device="cuda")`, from random final checkpoints
   made from a seed: the recipe's forward kernel once per layer per forward
   batch and no backward launch, finite 1944-wide posterior matrices
   agreeing with the plain path and, for two utterances, with the CPU path,
   and the peak device memory.  The plain path serves at the same forward
   batch, the port's default of 8 utterances.  The liGRU's forward stage
   runs once more at TPUKALDI_FORWARD_PIPELINE_DEPTH=1: its arks
   byte-equal to those of the default depth 6.  After the recipes'
   phases, the flagship at 5 x 2048 (`wide_phase`, WIDE_LAYERS) served the
   same way: K1f once per layer per forward batch and K1b never, its arks
   held to its `ligru_impl = scan` run on the card and two utterances to
   the CPU path, with frames/s and peak memory; then, with every count at
   0, each forward kernel at H = 2049 and a train step of the flagship at
   5 x 2048 each raise the ValueError that names the limit (2048; K1b's
   1024), and no kernel launches.
4. Training phase, per recipe, the slice's main path: the cfg over the same
   tree (train 64 utterances of 150-778 frames, dev 16; raw: 32 and 8),
   with 2 epochs of 2 train chunks and no sequence-length curriculum,
   through `run_experiment(device="cuda")`: train and valid chunks
   (gathered on the card from the device-resident corpus, the default),
   new-bob, res.res, final checkpoints, then the forward stage.  It checks
   the ledger, the checkpoints and the two `ep=` lines, that the train loss
   fell, that the forward kernel ran once per layer per (train + valid +
   forward) batch and the backward kernel once per layer per train batch
   (the runtime's own counters), the arks, and two utterances against the
   CPU path.  The first train chunk runs once more through the plain path
   for its frames/s, and one full-width train step at drop 0, on the
   cache's batch, holds the kernel path's gradients, and the plain
   path's, to a float64 run (for the liGRU, a float64 run that takes the
   path's own relu decisions where they differ from float64's at a near
   tie, each such element printed).  Each
   train chunk's asynchronous checkpoint hand-off (ckpt_block) and split
   drain (drain_compute, drain_fetch) and each epoch's `phases ep=` line
   (host_load, host_load_producer) are printed.  For the liGRU, a
   ChunkRuntime trains chunk 1, its state is copied to the host, and chunk
   2 starts at once, beside chunk 1's checkpoint writer: after `wait()`,
   chunk 1's checkpoints are byte-equal to the synchronous writer's from
   the host copy, and the writer's seconds are printed beside chunk 2's
   wall time.  After the recipes, SincNet at its published 251-tap layer
   0 (`sinc251_phase`: SincNet_raw.cfg with `sinc_len_filt = 251,5,5`,
   SINC251) over the raw tree: one train chunk at the card's default step
   graphs, its valid chunk and the forward stage through
   `run_experiment(device="cuda")`, K5f once per batch and K5b once per
   train batch (both more than 0; `sinc251_launches` on their records),
   the arks finite and two utterances held to the CPU path, frames/s from
   the `.info` files.
5. Profile phase, per recipe: the serving path's forward stage and one warm
   train chunk again under torch.profiler: device busy time, idle share,
   top device ops and, for the train chunk, device time by layer.  The
   warm chunk runs beside the previous chunk's checkpoint writer, as every
   chunk of a run does.
6. Device cache phase, the card's default train and valid data path
   (TPUKALDI_DEVICE_CACHE=auto, which every `run_experiment` training run
   above takes): on the flagship's tree, (a) one train chunk (the seeded
   random left offsets) and one valid chunk through the cache and through
   the host path, every batch gathered on the card equal to the host batch
   within CACHE_TOL and its labels, names, lengths and n_valid_t exactly;
   (b) the run at drop 0 with the cache forced on and off: the first
   train chunk's loss and err within CACHE_RUN_TOL (relative and
   absolute, as tpukaldi's test), the whole res.res within
   RES_SPREAD_FACTOR times the host path's own spread under a one-ulp
   change of its features (RES_SPREAD_SEEDS random ones); (c) the
   resident bytes, the first chunk load with its upload, each epoch's
   host_load_producer, and a warm train chunk's frames/s and idle share
   with the cache and with the host path, beside the card's name and
   power limit; (d) for each recipe of the
   training phases, the data path its train and valid chunks took (the
   cache, or the host path and the reason the cache gave).
7. Multistep phase, TPUKALDI_MULTISTEP (K): K1f captured alone into a
   CUDA graph and replayed, bitwise its eager call; then, per recipe, one
   train chunk and one valid chunk from one init at recipe dropout, on a
   fresh runtime at K = 1, at K = 1 again and at K = 8, where a chunk's
   groups of 8 same-shape batches run on captured step graphs.  The
   sequence recipes run over trees of their own whose train chunk (128
   utterances, one chunk) and dev chunk fall in one length bucket (310-400
   frames), so that they form groups as the length-sorted chunks of a full
   TIMIT epoch do; the raw recipes over the RAW tree.  K = 8 must give the
   K = 1 `.info` loss and err and checkpoints bitwise where the two K = 1
   runs agree bitwise, else final weights no further from the first K = 1
   run than MS_NOISE_FACTOR times the second is; the same launches of
   every kernel; its train steps as replays.  Printed: the `.info` loss,
   err and phases, captures, replays and eager steps, the graphs' pool
   bytes, and the same train chunk once more on the warm runtimes of the
   second K = 1 run and the K = 8 run under the profiler: frames/s,
   phase_dispatch, wall, device busy and idle share, and each hand
   kernel's launches in the trace, which must equal its launch counters
   but for MS_TRACE_LOST records the profiler may lose (on a replay the
   counters add what the capture counted).  The raw
   recipes' two K = 1 runs differ (cuDNN's weight gradients in layers
   1-3), so each runs the three again under deterministic cuDNN, where
   the two K = 1 runs must agree bitwise and K = 8 must give their `.info`
   loss and err and checkpoints bitwise.
   The training and profile phases above run at the card's default K = 8
   (their TIMIT and DIRHA chunks of 4 batches form no group; the raw
   chunks' do).
8. bf16 phase, the bf16 compute mode (`[exp] compute_dtype = bfloat16`,
   TPUKALDI_COMPUTE_DTYPE): each kernel's bf16 entry at the recipe shapes
   against its float32 entry, bitwise (K1-K3's Functions, K5's and K6's
   entries widen bf16 at their boundary: outputs and gradients the float32
   entry's on the widened inputs, rounded; K4f's bf16-ff entry the float32
   entry's on ff.float(), K4b's bf16 dff its dff rounded, its dU held to a
   float64 h_prev^T float(dff)), with the casts' device ms and K4's bf16
   entries timed beside their float32 entries with their bounds; then
   cfg/TIMIT/liGRU_fmllr_bf16.cfg and the QLSTM (under the env knob),
   each for one train chunk, its valid chunk and the forward stage through
   `run_experiment`: the kernels counted (K4 through its bf16 entries),
   float32 masters in the final checkpoints, and the train and forward
   frames/s beside float32 runs of the same cfg; the flagship's bf16
   serving posteriors from seeded finals within 0.05 of float32's; one
   bf16 train step, kernel path and scan, held to a float64 step (factor
   2); the bf16 chunk at K = 8 bitwise the K = 1 chunk, and its warm
   chunk profiled beside a float32 one.
9. Zoo phase, the classes that have no TPU kernel, each at its shipped
   cfg's widths (at ZOO_DEPTH = 1 of their layers, but fusionRNN at all
   4): RNN (cfg/TIMIT/RNN_fmllr.cfg, 5x550 bidirectional,
   tanh, batchnorm), minimalGRU (minimalGRU_fbank.cfg, 5x550), LSTM_cudnn
   (LSTM_fmllr_cudnn.cfg, 4x550 bidirectional; torch's LSTM, cuDNN in
   float32) and GRU_cudnn and RNN_cudnn at the same shape, SRU
   (SRU_fbank.cfg, 4x550 bidirectional) and fusionRNN
   (cfg/DIRHA/fusionRNN_mfcc_6ch.cfg, 4x512 with the 3072-wide fusion layer
   over 6 mics, on a DIRHA tree whose mfcc_6ch stream is 240 wide).  Each
   builds its graph from the cfg's seed on the card and a CPU twin, and on
   the first train batch (8 utterances of 150-778 frames) holds one forward
   with lengths (the valid frames) and one train step at drop 0 (the loss
   and every gradient) to the twin, with its ms a step and forward
   frames/s, and that train step captured into a step graph
   (`make_train_multistep`) and replayed against an eager step from the
   same state under deterministic cuDNN: the same loss and, after the two,
   bitwise the same parameters, buffers and optimizer state; each one's
   ms.  fusionRNN's recurrence is
   the liGRU's and runs K1 on the card: its K1f outputs are held to `ligru_recurrence_ref` on the same
   inputs, and it trains (one train chunk, then the forward stage) and
   serves through `run_experiment(device="cuda")`, with K1f and K1b
   counted and two utterances' posteriors held to the CPU path.  The
   phase prints its seconds; K1's rows of the kernels line carry their
   launches on this fusion path as `fusion_launches`.
10. Rate-differing phase (`rate_phase`), the raw-wave front ends that read
   16 kHz samples against 10 ms labels (a 6-int max_seq_length) into the
   flagship's 5x550 liGRU and heads (`flagship_tree.write_rate_cfg`):
   logMelFb_liGRU (40 mels, window 400, shift 160), PASE_liGRU (PASE at
   its published defaults, emb 100, window = shift = 160) and
   chavg_logMelFb_liGRU (channel_averaging over 6 channels, equal
   weights, then logMelFb), over trees of the TIMIT tree's utterance
   lengths as waveforms (`RATE_SPLITS`).  (a) Each front end on the card
   against a float64 CPU run of the same module (logMelFb in log10 units
   on bins within RATE_MEL_FLOOR of the utterance's largest energy, PASE
   in train and eval mode, channel_averaging); (b) the first two trained
   through `run_experiment` (2 epochs of 2 chunks, then the forward stage
   at batch 1) and the third for one chunk and its forward: K1f once per
   layer per batch and K1b once per layer per train batch, the plain scan
   never on the card, every chunk on the host path (rate-differing), one
   finite posterior row per label frame; each first train chunk at drop 0
   against a CPU twin (RATE_TWIN_TOL); (c) a train step of each held to
   float64 by `step_check`'s rule (`held_step`); (d) a chunk of long
   utterances at K = 8, its steps replayed on CUDA graphs keyed by the
   sample-rate T (cuFFT and cuDNN inside), bitwise the K = 1 chunk under
   deterministic cuDNN; (e) that chunk again at the card's defaults, warm
   (its steps replayed), under the profiler: samples/s, idle share,
   phase_dispatch and the front end's device ms against the liGRU
   recurrence's; (f) bf16 compute mode refused before any output.  K1's
   rows of the kernels line carry these runs' launches as
   `rate_launches`.

11. dist_export phase (`dist_export_phase`), the data-parallel mesh and
   the serving export on the flagship at full width (5x550
   bidirectional, batch 8) over the multistep phase's TIMIT tree: (a) a
   train and a valid chunk at K = 8 in an NCCL group of one rank (the
   gradient and loss all-reduces captured in the step graphs), its
   `.info` and checkpoints bitwise those of the run without a group; (b)
   two gloo ranks on the one card (spawned processes, eager: gloo's
   collectives do not capture), drop 0: one train step of the first batch
   split 4/4 against the one-process step (loss and err within
   DIST_LOSS_ATOL), the summed gradients held to float64 by
   `held_step`'s rule (each path's own relu decisions at its near ties),
   both ranks' gradients and weights bitwise equal, each rank's K1f and
   K1b counted, then a train chunk on each rank, rank 1 writing no file
   of the run; (c) the trained flagship of (a) exported at symbolic T and
   B (`tools/export_model.py`), served over the test split on the card
   against the live `forward_step` (DIST_FWD_ATOL, K1f counted from the
   artifact's launches) and on the CPU over two utterances against the
   plain path (DIST_CPU_ATOL).  K1's rows of the kernels line carry
   `dist_launches` (the NCCL run's, each gloo rank's) and K1f's
   `export_launches`.

The plain path of a TIMIT recurrent recipe is `*_impl = scan`, the plain
loop through autograd.  The QLSTM's is its bf16-U kernels' plain versions,
run on the card through the same autograd Function (`plain_recurrences`),
since the kernel path is held to the same bf16 arithmetic.  A raw recipe's
is `TPUKALDI_CONV_IMPL=nhc`, the composed path (cuDNN's conv, pooling and
the separate layer norm, activation and dropout).  Each path is driven with
every kernel's count set to 0 just before it and read just after; no
recipe path launches the stack's kernels.  Any failed check raises, so
the exit code is not 0.  The last lines are the card's name and power
limit, one JSON line with the kernels (the stack's with their launches on
its own path and `recipe_launches`, their count on the recipe paths),
and the result line.  Scratch files
go to build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
N_PDFS = 1944  # TIMIT's tri3 cd states; the DIRHA tree takes the same
N_PHONES = 48
FWD_SHAPES = ((778, 64, 550), (1000, 16, 550))
# the persistent float32 K1f, K2f and K3f also at the edges of their
# tiling: an odd batch with H not a multiple of 16, a batch of more than one
# pass (128 rows), and the QLSTM's width under qlstm_impl = scan (the
# largest U slice, h staged in chunks of fewer columns)
FWD_EDGE_SHAPES = ((37, 5, 36), (50, 136, 550), (50, 96, 1024))
BWD_SHAPES = ((778, 16, 550), (1000, 16, 550))
# the persistent K1b, K2b and K3b at K2f's edge shapes: their sequential
# passes run on K1f's and K2f's grids, with a pass of more than 128 rows and
# U's largest slice
BWD_EDGE_SHAPES = FWD_EDGE_SHAPES
# K3b in relu too (the GRU recipe runs tanh), at the training shape
GRU_RELU_BWD_SHAPES = ((778, 16, 550),)
# K3f in relu too, at the serving shape
GRU_RELU_FWD_SHAPES = ((778, 64, 550),)
# the QLSTM's recurrence: H = 1024; forward batch 32 and training batch 16,
# doubled by the bidirectional flip-concat
LEAN_FWD_SHAPES = ((778, 64, 1024), (1000, 32, 1024))
# K4f also at the edges of its tiling: an odd batch with H not a multiple of
# 16, and a batch of more than 64 rows (h staged in chunks of fewer columns)
LEAN_FWD_EDGE_SHAPES = ((37, 5, 36), (50, 96, 1024))
LEAN_BWD_SHAPES = ((778, 32, 1024), (1000, 32, 1024))
# the persistent K4b at K2b's edge shapes on K4f's grid: an odd batch with H
# not a multiple of 16, U's largest slice at 96 rows, and a batch of two
# passes (more than 128 rows)
LEAN_BWD_EDGE_SHAPES = ((37, 5, 36), (50, 96, 1024), (50, 136, 1024))
# the forward recurrences past the backward kernels' limit,
# K1f, K2f, K3f (both acts) and K4f (both entries): H = 2048 at the
# flagship's serving batch (8 doubled) and at 64 rows (u = 16, P = 128: the
# slices of U streamed past the rows that fit, csrc/u_stream.cuh), an odd
# width just past 1024, and 1536
WIDE_FWD_SHAPES = ((778, 16, 2048), (50, 64, 2048), (50, 5, 1036),
                   (50, 16, 1536))
FWD_MAX_HIDDEN, BWD_MAX_HIDDEN = 2048, 1024
# the flagship at that width (the serving run of `wide_phase`)
WIDE_LAYERS = {"ligru_lay = 550,550,550,550,550":
               "ligru_lay = 2048,2048,2048,2048,2048"}
# kernel vs plain version on the card: both float32, the recurrent products
# summed in another order per step, compounding over up to 1000 steps
# the train .info phases of the asynchronous hand-off and the split drain
PIPELINE_PHASES = ("ckpt_block", "drain_compute", "drain_fetch")
KERNEL_ATOL = 1e-4
# the backward kernels' dff and dmask as the forward's h; the weight
# gradients sum T*B = 16,000 rows in their own blocked order (the plain
# version in cuBLAS tiles), so they are held relative to their max, as h is
# (values of order 1)
DU_RTOL = 1e-4
# The bf16-U kernels against their plain versions.  Both round h (and in the
# backward dA) to a bf16 operand every step; their float32 sums of 1024
# products differ in order, so h differs by an ulp now and then, and where
# that ulp straddles a bf16 rounding tie the next step reads another
# operand, 2^-8 of h away.  Over hundreds of steps a few percent of the
# operands differ and the sequences drift apart, boundedly (the cell
# forgets): h and c to LEAN_SEQ_ATOL, dff and dmask to LEAN_BWD_ATOL, dU
# (the same cuBLAS GEMM on both sides, over that dff) to LEAN_DU_RTOL of its
# max.  So the forward is also held step by step: each step's h and c
# against one plain bf16 step from the kernel's own previous state, which
# removes the drift and leaves the sum order, to LEAN_STEP_ATOL.
LEAN_SEQ_ATOL = 2e-3
LEAN_STEP_ATOL = 1e-5
LEAN_BWD_ATOL = 5e-4
LEAN_DU_RTOL = 1e-3
# whole-path posteriors (log-probabilities minus log-priors, order 10):
# several such layers, batchnorm and a 1944-way log-softmax on each side
POSTERIOR_ATOL = 1e-3
# one full-width train step, kernel path vs plain path: the loss to 1e-4
# absolute (order 10).  Their gradients pass back through recurrences of
# hundreds of steps, where rounding grows with the chain, so each path is
# held to a float64 run of the plain float32 arithmetic: the kernel path's
# worst error (max |g - g64| / max |g64| over the tensors) may be at most
# STEP_GRAD_FACTOR times the plain path's, i.e. as accurate as PyTorch's
# own path of the same arithmetic up to the spread between two sum orders
# (for the QLSTM, the plain bf16 path: its products are bf16 by design)
STEP_LOSS_ATOL = 1e-4
STEP_GRAD_FACTOR = 2.0
# a trained recipe's arks where its weights amplify float32 rounding
# (LSTM_fmllr_cudnn.cfg after two rmsprop steps, saturated cells over 662
# steps, each float32 path 1.7e-4 to 6.6e-4 from float64): the same
# forward in float64 on the card and on the CPU, whose arithmetic differs
# only in its sum orders (rounding near 1e-16, amplified as float32's is,
# ~1e-12) and in the float32 log-softmax at the end (a few ulps of values
# near 10, ~1e-6)
F64_PATHS_ATOL = 1e-5
# The zoo phase: the classes with no TPU kernel, each at its shipped cfg's
# full widths (cfg/TIMIT/RNN_fmllr.cfg 5x550 bidirectional tanh with
# batchnorm; minimalGRU_fbank.cfg 5x550; LSTM_fmllr_cudnn.cfg 4x550
# bidirectional, and the same shape with GRU_cudnn and RNN_cudnn swapped in;
# SRU_fbank.cfg 4x550 bidirectional; cfg/DIRHA/fusionRNN_mfcc_6ch.cfg 4x512
# with the 3072-wide fusion layer over 6 mics): class -> (tree, recipe,
# cfg replacements that make it).  Each is held on the card to a CPU twin
# from the cfg's seed: the loss of one train step at drop 0 to
# STEP_LOSS_ATOL, each gradient to ZOO_GRAD_RTOL of the largest gradient of
# its architecture (float32 on both sides, sums over recurrences of up to
# 778 steps in other orders; rounding scales with the terms summed, and a
# batchnorm's bias gradient sums T * B' terms that mostly cancel, so its
# own max is no scale for it), and a forward with lengths on the valid
# frames to POSTERIOR_ATOL.  fusionRNN's gradients, which pass through K1b,
# are held as `step_check` holds the liGRU recipe's: to a float64 run of the
# CPU twin, at most STEP_GRAD_FACTOR times as far from it as the CPU twin.
ZOO = {
    "RNN": ("TIMIT", "RNN", {}),
    "minimalGRU": ("TIMIT", "minimalGRU", {}),
    "LSTM_cudnn": ("TIMIT", "LSTM_cudnn", {}),
    "GRU_cudnn": ("TIMIT", "LSTM_cudnn",
                  {"arch_class = LSTM_cudnn": "arch_class = GRU_cudnn"}),
    "RNN_cudnn": ("TIMIT", "LSTM_cudnn",
                  {"arch_class = LSTM_cudnn": "arch_class = RNN_cudnn"}),
    "SRU": ("TIMIT", "SRU", {}),
    "fusionRNN": ("DIRHA6", "fusionRNN", {}),
}
# the step checks of the classes without a kernel run the cfg's widths at
# this many of their 4-5 layers (one, to leave the script's time to the
# dist_export phase)
ZOO_DEPTH = 1
ZOO_GRAD_RTOL = 1e-4
# fusionRNN's Linear biases sit right before a batchnorm, whose mean cancels
# them: their gradient is zero but for rounding (CPU and card alike), so
# they are held to be tiny against the largest gradient, not to a relative
# error
ZOO_INERT = re.compile(r"fusionRNN_layers\.w\.\d+\.bias")
ZOO_INERT_RTOL = 1e-5
# the generator seed of the zoo's eager and graphed step (drop 0: no mask)
ZOO_GRAPH_SEED = 11
# fusionRNN's tree: a 6-mic mfcc_6ch stream 240 wide (6 x 40)
ZOO_TREE = dict(dim=240, splits={"train": (16, 150, 778), "dev": (4, 150, 778),
                                 "test": (16, 150, 778)})
# 8 utterances a train batch, as the TIMIT recipes have it; fusionRNN's
# run through run_exp trains one chunk of one epoch
ZOO_CUTS = {"batch_size_train = 16": "batch_size_train = 8"}
FUSION_RUN_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1",
                   "n_chunks = 5": "n_chunks = 1", **ZOO_CUTS}
FUSION_LAYERS = 4
# LSTM_fmllr_cudnn.cfg's run through run_exp: one train chunk of 16
# utterances, then the forward stage over 13, which leaves every forward
# batch of 8 padded with rows of length 0
CUDNN_TREE = dict(dim=40, splits={"train": (16, 150, 778), "dev": (4, 150, 778),
                                  "test": (13, 150, 778)})
CUDNN_RUN_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1",
                  "n_chunks = 5": "n_chunks = 1",
                  "increase_seq_length_train = True":
                  "increase_seq_length_train = False"}
# recipe -> its kernel module's cell, forward and backward kernel, layers,
# tree and cuts (2 epochs of 2 train chunks, no sequence-length curriculum;
# the DIRHA cfg has none already)
RECIPES = {
    "liGRU": dict(cell="ligru", fwd="ligru_fwd", bwd="ligru_bwd", layers=5,
                  corpus="TIMIT", batch=8),
    "LSTM": dict(cell="lstm", fwd="lstm_fwd", bwd="lstm_bwd", layers=5,
                 corpus="TIMIT", batch=8),
    "GRU": dict(cell="gru", fwd="gru_fwd", bwd="gru_bwd", layers=5,
                corpus="TIMIT", batch=8),
    "QLSTM": dict(cell="lstm_lean", fwd="lstm_lean_fwd", bwd="lstm_lean_bwd",
                  layers=2, corpus="DIRHA", batch=16),
    # the raw-waveform recipes: one kernel layer (layer 0), frame batches of
    # 128 windows of 3200 samples; CNN_raw's layer 0 (128 filters, layer
    # norm, relu) takes K6, SincNet_raw's (80 filters, leaky_relu) K5
    "CNN": dict(cell="conv1d", fwd="conv_ln_fwd", bwd="conv_ln_bwd", layers=1,
                corpus="RAW", batch=128, filters=128),
    "SincNet": dict(cell="conv1d", fwd="conv_pool_fwd", bwd="conv_pool_bwd",
                    layers=1, corpus="RAW", batch=128, filters=80),
}
# each tree's stream width (for the raw stream, its window length) and its
# splits: train, dev, test as (utterances, min frames, max frames).  The raw
# tree is sized by its bytes (a frame is 12.8 KB): 88 utterances of 150-778
# frames, ~0.5 GB of arks
TREES = {
    "TIMIT": dict(dim=40, splits={"train": (64, 150, 778), "dev": (16, 150, 778),
                                  "test": (192, 150, 778)}),
    "DIRHA": dict(dim=40, splits={"train": (64, 150, 778), "dev": (16, 150, 778),
                                  "test": (192, 150, 778)}),
    "RAW": dict(dim=3200, splits={"train": (32, 150, 778), "dev": (8, 150, 778),
                                  "test": (48, 150, 778)}),
}
TRAIN_CUTS = {
    "n_epochs_tr = 24": "n_epochs_tr = 2",
    "n_chunks = 5": "n_chunks = 2",  # the train set's; dev and test keep 1
}
TIMIT_CUTS = {"increase_seq_length_train = True":
              "increase_seq_length_train = False"}
GRU_ACT = "tanh"  # the GRU recipe's activation
# kernel -> (module, launch counter, source attribute, the Pallas kernel
# body it replaces)
KERNELS = {
    "ligru_fwd": ("ligru", "launches", "SOURCE", "tpukaldi/kernels/ligru.py:41"),
    "ligru_bwd": ("ligru", "bwd_launches", "BWD_SOURCE",
                  "tpukaldi/kernels/ligru.py:106"),
    "lstm_fwd": ("lstm", "launches", "SOURCE", "tpukaldi/kernels/lstm.py:43"),
    "lstm_bwd": ("lstm", "bwd_launches", "BWD_SOURCE",
                 "tpukaldi/kernels/lstm.py:128"),
    "gru_fwd": ("gru", "launches", "SOURCE", "tpukaldi/kernels/gru.py:49"),
    "gru_bwd": ("gru", "bwd_launches", "BWD_SOURCE",
                "tpukaldi/kernels/gru.py:119"),
    "lstm_lean_fwd": ("lstm", "lean_launches", "LEAN_SOURCE",
                      "tpukaldi/kernels/lstm.py:390"),
    "lstm_lean_bwd": ("lstm", "lean_bwd_launches", "LEAN_BWD_SOURCE",
                      "tpukaldi/kernels/lstm.py:465"),
    "conv_pool_fwd": ("conv1d", "launches", "SOURCE",
                      "tpukaldi/kernels/conv1d.py:123"),
    "conv_pool_bwd": ("conv1d", "bwd_launches", "BWD_SOURCE",
                      "tpukaldi/kernels/conv1d.py:191"),
    "conv_ln_fwd": ("conv1d", "ln_launches", "LN_SOURCE",
                    "tpukaldi/kernels/conv1d.py:588"),
    "conv_ln_bwd": ("conv1d", "ln_bwd_launches", "LN_BWD_SOURCE",
                    "tpukaldi/kernels/conv1d.py:627"),
    # the whole raw conv stack (`conv_stack_fused`), which no recipe calls
    "conv_stack_fwd": ("conv_stack", "launches", "SOURCE",
                       "tpukaldi/kernels/conv_stack.py:214"),
    "conv_stack_bwd": ("conv_stack", "bwd_launches", "BWD_SOURCE",
                       "tpukaldi/kernels/conv_stack.py:268"),
}
STACK_KERNELS = ("conv_stack_fwd", "conv_stack_bwd")
# device kernel (its name in a profiler trace) -> the KERNELS whose
# wrappers launch it, once a call: a trace's count of it equals the sum of
# their launch counters.  K5b's and K6b's wrappers both launch the dW
# partials of `csrc/conv_pool_bwd.cuh`, so it counts the two
KERNEL_EVENTS = {
    "ligru_fwd_kernel": ("ligru_fwd",),
    "ligru_bwd_seq_kernel": ("ligru_bwd",),
    "lstm_fwd_kernel": ("lstm_fwd",),
    "lstm_bwd_seq_kernel": ("lstm_bwd",),
    "gru_fwd_kernel": ("gru_fwd",),
    "gru_bwd_seq_kernel": ("gru_bwd",),
    "lstm_lean_fwd_kernel": ("lstm_lean_fwd",),
    "lstm_lean_bwd_seq_kernel": ("lstm_lean_bwd",),
    "conv_pool_fwd_kernel": ("conv_pool_fwd",),
    "conv_pool_dw_part_kernel": ("conv_pool_bwd", "conv_ln_bwd"),
    "conv_ln_fwd_kernel": ("conv_ln_fwd",),
    "conv_ln_bwd_kernel": ("conv_ln_bwd",),
    "stack_ln_fwd_kernel": ("conv_stack_fwd",),
    "stack_ln_bwd_kernel": ("conv_stack_bwd",),
}
# the conv kernels at the raw recipes' shapes: the training batch (128
# windows of 3200 samples, K = 129, pool 3; O = 80 for SincNet's K5, 128
# for CNN's K6), a serving batch (32 utterances padded to the 1000-frame
# bucket: 32,000 windows, at TPUKALDI_FORWARD_BATCH=32; the default of 8
# makes a quarter of it), and an odd shape (N not a multiple of 8, K <
# 128, a pool tail, a partial filter tile)
CONV_TRAIN = (128, 3200, 129, 3)
CONV_SERVE_N = 32000
CONV_ODD = (13, 701, 100, 7, 3)
# a slice of the serving batch held to the plain version (the windows are
# independent), and the plain version's timing batch: its conv output at
# 32,000 windows alone would be 50 GB
CONV_SERVE_CHECK = 1024
CONV_SERVE_PLAIN_N = 4000
# kernel vs plain version: float32 sums of 129 products in another order
# (outputs of order 1-10); the gradients sum 131k terms (dW) or 16.5k (dX)
# in their own blocked order, held relative to each tensor's max
CONV_ATOL = 1e-5
CONV_GRAD_RTOL = 2e-5
# K5f's and K6f's argmax against the plain version's on random inputs: a
# conv value summed in another order flips a near-tie, at most this many
# elements per call (both counted 0 at every conv shape in the runs before
# the register tile, which keeps every chain; the stack's bound,
# STACK_MAX_FLIPS).  Exact ties almost never occur in such inputs, so this
# bound catches a misplaced window or a wrong sum order, not a wrong tie
# rule: CONV_TIES holds that.
CONV_MAX_FLIPS = 10
CONV_DROP = 0.15  # CNN_raw's layer-0 dropout
# cfg/TIMIT/CNN_fbank.cfg's layer 0, which the port routes to K6: spliced
# fbank frames (40 x 11 = 440), K = 10, pool 3, 80 filters, batch 128
CONV_FBANK = (128, 440, 10, 80, 3)
# K5f's and K6f's first-match argmax where ties are common: x and w drawn
# from {-1, 0, 1}, so every conv value is an integer, exact in any sum
# order, and many pooling windows reach their max twice; the kernels'
# argmax must be the plain version's at every element (a last-match rule
# flips every tie) and their pooled values its bits.  At the training
# window (the long block) and CNN_fbank's (the short block)
CONV_TIES = ((16, 3200, 129, 80, 3), (16, 440, 10, 80, 3))
# the forwards' other launch paths, held to the plain version: K5f in row
# blocks (a long window at pool 1, its last block short) and K6f with one
# pooled-row buffer; odd L, so the second window's start is not 16-byte
# aligned and its span takes the plain per-thread load
CONV_LONG_K5 = (2, 20001, 129, 16, 1)
CONV_LONG_K6 = (2, 4501, 129, 20, 3)
# SincNet's published layer 0 (Ravanelli & Bengio, "Speaker Recognition
# from Raw Waveform with SincNet", SLT 2018; cfg/SincNet_TIMIT.cfg of
# github.com/mravanelli/SincNet): 251 taps at the training batch, K5 at
# SincNet's 80 filters, K6 at CNN_raw's 128, pool 3; and a pool longer
# than the forwards' run of 12 conv positions
CONV_251 = (128, 3200, 251, 3)
CONV_LONG_POOL = (16, 3200, 251, 80, 16)
# sinc251_phase: cfg/TIMIT/SincNet_raw.cfg at the paper's filter lengths
# (its [architecture1] otherwise as shipped), one train chunk, its valid
# chunk, then the forward stage
SINC251 = {"sinc_len_filt = 129,5,3": "sinc_len_filt = 251,5,5"}
SINC251_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1",
                "n_chunks = 5": "n_chunks = 1"}
# the whole conv stack (K7f, K7b) at CNN_raw's shapes (its [architecture1]
# cnn_* fields): the training batch of 128 windows and the serving batch;
# a slice of the serving batch is held to the plain version
STACK_TRAIN_N = 128
STACK_SERVE_CHECK = 256
# K7f vs its plain version and vs the per-layer path: outputs of order 1-10
# after four chained float32 layer norms, each dividing by a std, with the
# conv sums in other orders; K7b's gradients, given the kernel's own
# residuals, relative to each tensor's max (dW sums 43.5k-131k terms)
STACK_ATOL = 5e-5
STACK_GRAD_RTOL = 1e-4
# K7f's saved residuals: every layer's output (the next layer's input) and
# its (mean, std) within STACK_ATOL; its argmax may differ from the plain
# version's only at near-ties, at most this many elements per layer
STACK_MAX_FLIPS = 10
# K7b on the kernel's residuals against the plain backward on the plain
# forward's own: a near-tie flip moves one pooled gradient to its
# neighbouring row (a top-layer flip ~2e-3 of dx's norm at this shape), so
# each gradient is held normwise, ||got - want|| / ||want||
STACK_GRAD_NORM_RTOL = 1e-2
# the stack's own path: steps through `conv_stack_fused` with dropout, then
# one forward without a gradient
STACK_STEPS = 3
# the card's published peaks (H100 SXM, dense): memory, float32 outside
# the tensor cores, bf16 tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}


def _raw(recipe):
    return RECIPES[recipe]["corpus"] == "RAW"


def _cuts(recipe):
    return _cuts_for(RECIPES[recipe]["corpus"])


def _cuts_for(corpus):
    return {**TRAIN_CUTS, **(TIMIT_CUTS if corpus == "TIMIT" else {})}


@contextlib.contextmanager
def _env(**values):
    """Environment knobs for the runs inside (TPUKALDI_CONV_IMPL is read
    where a module is built, TPUKALDI_FORWARD_BATCH per forward task)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _scan(recipe):
    """cfg replacements that run the recipe's plain recurrence: the liGRU
    cfg has an `ligru_impl` line; the LSTM and GRU cfgs have none, so the
    line is added.  The QLSTM's `scan` is the float32 recurrence."""
    p = recipe.lower()
    if recipe == "liGRU":
        return {"ligru_impl = auto": "ligru_impl = scan"}
    if recipe == "QLSTM":
        return {"autograd = False": "autograd = False\nqlstm_impl = scan"}
    return {f"{p}_orthinit = True": f"{p}_orthinit = True\n{p}_impl = scan"}


def _no_drop(recipe):
    if recipe == "QLSTM":
        return {"lstm_drop = 0.2,0.2": "lstm_drop = 0.0,0.0"}
    if _raw(recipe):
        # the head's dropout too: the composed path draws layer 0's mask from
        # the generator where the kernel path draws one seed, so the two
        # paths' later draws part
        head = {"dnn_drop = 0.15,0.15,0.0": "dnn_drop = 0.0,0.0,0.0"}
        if recipe == "CNN":
            return {**head, "cnn_drop = 0.15,0.15,0.15,0.15":
                    "cnn_drop = 0.0,0.0,0.0,0.0"}
        return head
    p = recipe.lower()
    return {f"{p}_drop = 0.2,0.2,0.2,0.2,0.2": f"{p}_drop = 0.0,0.0,0.0,0.0,0.0"}


@contextlib.contextmanager
def plain_recurrences(lstm):
    """The LSTM Functions run their plain versions on the card, float32 and
    bf16-U alike: the QLSTM's plain path, and its float64 reference."""
    plain = {"lstm_recurrence": lstm.lstm_recurrence_ref,
             "lstm_recurrence_bwd": lstm.lstm_recurrence_bwd_ref,
             "lstm_recurrence_lean": lstm.lstm_recurrence_lean_ref,
             "lstm_recurrence_lean_bwd": lstm.lstm_recurrence_lean_bwd_ref}
    saved = {n: getattr(lstm, n) for n in plain}
    for n, fn in plain.items():
        setattr(lstm, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(lstm, n, fn)


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


def queued_ms(fn, n: int = 20) -> float:
    """The device's ms a call of fn, without the host's share: n calls
    queued behind a sleep of the card long enough for the host to launch
    them all, between two events."""
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


def _recurrence_inputs(cell, T, B, H, seed):
    """ff (T, B, G*H), the cell's recurrent weights (orthogonal (H, H)
    blocks), a train-style mask and a gradient of h, on the card."""
    n_gates = {"ligru": 2, "lstm": 4, "gru": 3, "lstm_lean": 4}[cell]
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
    (ff, *ws, mask) -> h (for the bf16-U cell, whose plain forward rounds
    and so has no gradient of its own, `loop` is None)."""
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
    if cell in ("lstm", "lstm_lean"):
        lean = "_lean" if cell == "lstm_lean" else ""
        fwd = getattr(mod, f"lstm_recurrence{lean}")
        fwd_ref = getattr(mod, f"lstm_recurrence{lean}_ref")
        bwd = getattr(mod, f"lstm_recurrence{lean}_bwd")
        bwd_ref = getattr(mod, f"lstm_recurrence{lean}_bwd_ref")
        return dict(
            fwd=lambda ff, ws, m: fwd(ff, *ws, m),
            fwd_ref=lambda ff, ws, m: fwd_ref(ff, *ws, m),
            bwd=lambda ff, outs, g, ws, m: bwd(ff, *outs, g, *ws, m),
            bwd_ref=lambda ff, outs, g, ws, m: bwd_ref(ff, *outs, g, *ws, m),
            fn=(mod.LSTMLeanRecurrence if lean else mod.LSTMRecurrence).apply,
            loop=None if lean else (lambda *a: mod.lstm_recurrence_ref(*a)[0]),
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _lean_step_error(ff, u, mask, h, c):
    """K4f's h and c at every step against one plain bf16 step from the
    kernel's own h and c of the step before: the per-step arithmetic
    without the drift of rounding ties."""
    T, B, H4 = ff.shape
    H = H4 // 4
    zeros = h.new_zeros((1, B, H))
    h_prev = torch.cat([zeros, h[:-1]])
    c_prev = torch.cat([zeros, c[:-1]])
    a = ff + (_bf16(h_prev).reshape(T * B, H) @ _bf16(u)).reshape(T, B, H4)
    f, i, o = (torch.sigmoid(a[..., k * H:(k + 1) * H]) for k in range(3))
    c_step = i * torch.tanh(a[..., 3 * H:]) * mask + f * c_prev
    h_step = o * torch.tanh(c_step)
    return max((h - h_step).abs().max().item(),
               (c - c_step).abs().max().item())


# the recurrent products of one call per (T, B, H), as multiples of T B H^2,
# and their precision: the forward's per-step product, and the backward's
# remat, dh chain and dU (K4b's dU is a float32 GEMM after the bf16 kernel)
FLOPS = {
    "ligru_fwd": {"f32": 4}, "ligru_bwd": {"f32": 12},
    "lstm_fwd": {"f32": 8}, "lstm_bwd": {"f32": 24},
    "gru_fwd": {"f32": 6}, "gru_bwd": {"f32": 18},
    "lstm_lean_fwd": {"bf16": 8}, "lstm_lean_bwd": {"bf16": 16, "f32": 8},
}
# float32 words each call reads and writes once, as (per T B H, per H^2,
# per B H): the gate inputs, h (and c), g and dff; U and dU; mask and dmask
WORDS = {
    "ligru_fwd": (3, 2, 1), "ligru_bwd": (6, 4, 2),
    "lstm_fwd": (6, 4, 1), "lstm_bwd": (11, 8, 2),
    "gru_fwd": (4, 3, 1), "gru_bwd": (8, 6, 2),
    "lstm_lean_fwd": (6, 4, 1), "lstm_lean_bwd": (11, 8, 2),
}


# the forwards' U as the kernels hold it: (multiple of H^2, bytes an
# element), and the shared memory of the whole card (132 SMs of 232,448
# bytes a block may opt in to)
U_BYTES = {"ligru_fwd": (2, 4), "lstm_fwd": (4, 4), "gru_fwd": (3, 4),
           "lstm_lean_fwd": (4, 2)}
SMEM_BYTES = 132 * 232448
# the card's L2: {"bytes": its size, "rate": the bytes a second it serves
# from a buffer that stays in it}, both read in this run by `measure_l2`
L2 = {}
# the buffers `measure_l2` reads over and over, in bytes; it keeps the
# fastest
L2_PROBE_BYTES = (4 << 20, 16 << 20, 30 << 20)


def bound_ms(name, T, B, H, words=None, l2=None):
    """(least ms the card could take for one call at (T, B, H), "bytes" or
    "operations"): each input read once and each output written once at the
    memory's peak, against the recurrent products at the peak of their
    precision (the gate arithmetic adds under 1% at these H).  A forward's
    U that exceeds all the card's shared memory cannot stay on chip (at
    H = 2048 every forward's U does), so its excess is read again at each
    step after the first: from L2 as far as it fits there, at L2's rate
    (`l2`, as `L2`, which it defaults to), and from device memory past that.
    Every byte reaches the SMs through L2, so then the bytes take the
    longer of device memory's time and L2's.  `words` replaces WORDS[name]
    (K4's bf16 entries: BF16_WORDS)."""
    tbh, hh, bh = words or WORDS[name]
    once = 4 * (tbh * T * B * H + hh * H * H + bh * B * H)
    bytes_ms = once / PEAK_BYTES * 1e3
    mult, size = U_BYTES.get(name, (0, 0))
    excess = max(0, mult * H * H * size - SMEM_BYTES)
    if excess:
        l2 = l2 or L2
        device = once + (T - 1) * max(0, excess - l2["bytes"])
        bytes_ms = max(device / PEAK_BYTES,
                       (once + (T - 1) * excess) / l2["rate"]) * 1e3
    ops_ms = sum(n * T * B * H * H / PEAK_FLOPS[p]
                 for p, n in FLOPS[name].items()) * 1e3
    return (bytes_ms, "bytes") if bytes_ms > ops_ms else (ops_ms, "operations")


def measure_l2() -> None:
    """The card's L2 size and read rate, from csrc/l2_read.cu: the probe over
    each buffer of L2_PROBE_BYTES, enough passes a launch to read about
    2 GB, the median of 5 launches each; the fastest rate, stored in L2 for
    `bound_ms`."""
    import ctypes

    from tpukaldi_torch.kernels import _build

    lib = _build.load("l2_read.cu")
    entry = lib.tpk_l2_read
    entry.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    entry.restype = ctypes.c_int
    size = ctypes.c_int(0)
    err = lib.tpk_l2_bytes(ctypes.byref(size))
    check(err == 0 and size.value > 0,
          f"the L2 size query failed with CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    rates = {}
    for nbytes in L2_PROBE_BYTES:
        check(nbytes < size.value,
              f"an L2 probe of {nbytes} bytes exceeds the L2's {size.value}")
        buf = torch.zeros(nbytes // 4, device="cuda")
        reps = -(-(2 << 30) // nbytes)

        def run():
            err = entry(buf.data_ptr(), nbytes // 16, reps,
                        4 * sms, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"the L2 probe failed with CUDA error {err}")

        rates[nbytes] = reps * nbytes / (median_ms(run, 5) * 1e-3)
    torch.cuda.synchronize()
    check(out.item() == 0.0, "the L2 probe wrote its sum")
    L2.update(bytes=size.value, rate=max(rates.values()))
    print(f"L2: {size.value} bytes; read rate "
          + ", ".join(f"{r / 1e12:.4f} TB/s over {n} bytes"
                      for n, r in rates.items())
          + f" (bounds take {L2['rate'] / 1e12:.4f}; device memory's peak "
          f"{PEAK_BYTES / 1e12:g})", flush=True)


def _gate_perm(x, H):
    """The gate columns [f | i | o | c] in cuDNN's order [i | f | c | o]."""
    return torch.cat([x[..., H:2 * H], x[..., :H], x[..., 3 * H:],
                      x[..., 2 * H:3 * H]], dim=-1)


def _cudnn_lstm(ff, u, dtype):
    """torch.nn.LSTM (cuDNN) with U as its recurrent weight, gates permuted,
    an identity input weight and no bias, and ff permuted as its input."""
    H = u.shape[0]
    with torch.no_grad():
        m = torch.nn.LSTM(4 * H, H, bias=False, device=ff.device, dtype=dtype)
        m.weight_ih_l0.copy_(torch.eye(4 * H))
        m.weight_hh_l0.copy_(_gate_perm(u, H).t())
        m.flatten_parameters()
    return m, _gate_perm(ff, H).to(dtype).contiguous()


def library_ms(lstm, ff, u, dtype):
    """One cuDNN LSTM call (torch.nn.LSTM) over the same ff and U at mask 1,
    the gates permuted into its i, f, g, o order, with an identity input
    weight, so it also runs a (T B, 4H) x (4H, 4H) input GEMM that the
    kernels do not: (ms of the call, ms of that GEMM alone, max |h - the
    kernel's h at mask 1|)."""
    H = u.shape[0]
    m, x = _cudnn_lstm(ff, u, dtype)
    with torch.no_grad():
        ones = torch.ones(ff.shape[1], H, device=ff.device)
        kernel = (lstm.lstm_recurrence if dtype == torch.float32
                  else lstm.lstm_recurrence_lean)
        err = (m(x)[0].float() - kernel(ff, u, ones)[0]).abs().max().item()
        eye = torch.eye(4 * H, device=ff.device, dtype=dtype)
        gemm_ms = median_ms(lambda: x.view(-1, 4 * H) @ eye, 5)
        return median_ms(lambda: m(x), 5), gemm_ms, err


def library_bwd_ms(lstm, ff, u, grad, dtype):
    """cuDNN's backward of `library_ms`'s call: one forward with grad, then
    torch.autograd.grad of its output against the input and weight_hh_l0
    with grad_outputs `grad`, only the backward timed.  It also forms the
    input weight's gradient and the input gradient through the identity
    input weight, which the kernels do not.  That input gradient is the
    kernels' dff at mask 1 with the gates permuted: (ms of the backward,
    max |dx - the kernel's dff at mask 1|)."""
    H = u.shape[0]
    m, x = _cudnn_lstm(ff, u, dtype)
    x.requires_grad_()
    y = m(x)[0]
    go = grad.to(dtype)

    def backward():
        return torch.autograd.grad(y, (x, m.weight_hh_l0), go,
                                   retain_graph=True)

    ms = median_ms(backward, 5)
    with torch.no_grad():
        ones = torch.ones(ff.shape[1], H, device=ff.device)
        lean = "" if dtype == torch.float32 else "_lean"
        h, c = getattr(lstm, f"lstm_recurrence{lean}")(ff, u, ones)
        dff = getattr(lstm, f"lstm_recurrence{lean}_bwd")(ff, h, c, grad, u,
                                                          ones)[0]
        err = (backward()[0].float() - _gate_perm(dff, H)).abs().max().item()
    return ms, err


def _k2b_ms(lstm, T, B, H):
    """K2b's median ms at (T, B, H), on LSTM inputs made as the kernel
    phase makes them: the float32 backward of the same shape beside K3b."""
    ff, ws, mask, grad = _recurrence_inputs("lstm", T, B, H, T * B)
    h, c = lstm.lstm_recurrence(ff, *ws, mask)
    return median_ms(lambda: lstm.lstm_recurrence_bwd(ff, h, c, grad, *ws,
                                                       mask), 3)


def kernel_phase(mods) -> dict:
    """Every kernel against its plain version at the main paths' shapes;
    returns {kernel name: worst error}, {(kernel name, T, B, H): (ms, plain
    ms)}, {kernel name: (library ms, T, B, H)} and the forwards' library
    ms at WIDE_FWD_SHAPES[0] (`library_wide`)."""
    errs, timing, library, library_wide = {}, {}, {}, {}
    for cell, mod in mods.items():
        lean = cell == "lstm_lean"
        # the persistent kernels, forward K4f, K1f, K2f and K3f, backward
        # K1b, K2b, K3b and K4b: their plans, edge shapes and a bitwise repeat
        persistent_fwd = cell in ("ligru", "lstm", "gru", "lstm_lean")
        persistent_bwd = cell in ("ligru", "lstm", "gru", "lstm_lean")
        name = f"{cell}_fwd"
        # K3f also in relu, K4f also through its bf16-ff entry (None: the
        # cell's own act, float32 ff), at one shape after the other
        shapes = (LEAN_FWD_SHAPES + LEAN_FWD_EDGE_SHAPES if lean
                  else FWD_SHAPES + FWD_EDGE_SHAPES) + WIDE_FWD_SHAPES
        also, also_shapes = (
            ("relu", GRU_RELU_FWD_SHAPES + WIDE_FWD_SHAPES) if cell == "gru"
            else ("bf16 ff", WIDE_FWD_SHAPES) if lean else (None, ()))
        runs = [(*shape, act) for shape in shapes
                for act in dict.fromkeys((None, also))
                if act is None or shape in also_shapes]
        inputs = {}
        for T, B, H, act in runs:
            fns = _cell_fns(cell, mod, None if act == "bf16 ff" else act)
            label = f"{name}" + (f" {act}" if act else "")
            if (T, B, H) not in inputs:
                inputs = {(T, B, H): _recurrence_inputs(cell, T, B, H, T + B)}
            ff, ws, mask, _ = inputs[(T, B, H)]
            if act == "bf16 ff":  # held on ff rounded, which it widens
                ff = ff.to(torch.bfloat16)
            with torch.inference_mode():
                got = fns["fwd"](ff, ws, mask)
                want = fns["fwd_ref"](ff, ws, mask)
                # K4f, K1f, K2f and K3f sum in a fixed order: a second call
                # gives the same bits
                same = (all(torch.equal(a, b) for a, b in
                            zip(got, fns["fwd"](ff, ws, mask)))
                        if persistent_fwd else True)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                rel = err / max(b.abs().max().item() for b in want)
                step = (_lean_step_error(ff.float(), *ws, mask, *got) if lean
                        else None)
                ms = median_ms(lambda: fns["fwd"](ff, ws, mask), 5)
                plain_ms = median_ms(lambda: fns["fwd_ref"](ff, ws, mask), 3)
                # the float32 kernel on the same inputs, twice K4f's bytes
                k2_ms = (median_ms(lambda: mod.lstm_recurrence(ff, *ws, mask), 3)
                         if lean and act is None else None)
            atol = LEAN_SEQ_ATOL if lean else KERNEL_ATOL
            print(f"kernel {label} T={T} B={B} H={H}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} (atol {atol:g})"
                  + (f", per step {step:.3e} (atol {LEAN_STEP_ATOL:g})"
                     if lean else "")
                  + f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                  + (f", K2f at this shape {k2_ms:.3f} ms"
                     if k2_ms is not None else ""),
                  flush=True)
            if persistent_fwd:
                plan = (mod.lean_fwd_plan if lean else mod.fwd_plan)(B, H)
                bound, bound_by = bound_ms(
                    name, T, B, H,
                    BF16_WORDS[name] if act == "bf16 ff" else None)
                print(f"kernel {label} T={T} B={B} H={H}: {1e3 * ms / T:.2f} us "
                      f"per step; grid P={plan['ctas']} CTAs of u="
                      f"{plan['units']} units, {plan['smem_bytes']} shared-memory "
                      f"bytes a CTA, h staged {plan['chunk']} columns at a time, "
                      f"k_res={plan['k_res']} rows of U resident a CTA, "
                      f"{plan['stream_bytes']} bytes of U streamed a step; bound "
                      f"{bound:.3f} ms ({bound_by}); repeat bitwise equal: "
                      f"{same}", flush=True)
            check(math.isfinite(err) and err <= atol,
                  f"{label} disagrees with its plain version at {(T, B, H)}: {err}")
            if lean:
                check(math.isfinite(step) and step <= LEAN_STEP_ATOL,
                      f"{label} step disagrees at {(T, B, H)}: {step}")
            check(same, f"{label}: two calls differ at {(T, B, H)}")
            errs[name] = max(errs.get(name, 0.0), err)
            if act is None:  # the kernels line times the recipe's act
                timing[(name, T, B, H)] = (ms, plain_ms)
            if (name in ("lstm_fwd", "lstm_lean_fwd") and act is None
                    and (name not in library
                         or (T, B, H) == WIDE_FWD_SHAPES[0])):
                dtype = torch.bfloat16 if lean else torch.float32
                lib_ms, gemm_ms, lib_err = library_ms(mod, ff, ws[0], dtype)
                (library if name not in library
                 else library_wide)[name] = (lib_ms, T, B, H)
                print(f"library {name} T={T} B={B} H={H}: cuDNN LSTM "
                      f"({str(dtype)[6:]}) {lib_ms:.3f} ms, of which the "
                      f"identity input GEMM alone {gemm_ms:.3f} ms; h vs the "
                      f"kernel at mask 1: max_abs_err={lib_err:.3e}", flush=True)

        name = f"{cell}_bwd"
        # K1b, K2b, K3b and K4b, persistent: their plans, edge shapes and a
        # bitwise repeat; K3b also in relu (None: the cell's own act)
        shapes = (LEAN_BWD_SHAPES + LEAN_BWD_EDGE_SHAPES if lean
                  else BWD_SHAPES + BWD_EDGE_SHAPES if persistent_bwd
                  else BWD_SHAPES)
        runs = [(*shape, None) for shape in shapes]
        if cell == "gru":
            runs += [(*shape, "relu") for shape in GRU_RELU_BWD_SHAPES]
        for T, B, H, act in runs:
            fns = _cell_fns(cell, mod, act)
            label = f"{name}" + (f" {act}" if act else "")
            ff, ws, mask, grad = _recurrence_inputs(cell, T, B, H, T * B)
            with torch.inference_mode():
                outs = fns["fwd"](ff, ws, mask)
                got = fns["bwd"](ff, outs, grad, ws, mask)
                want = fns["bwd_ref"](ff, outs, grad, ws, mask)
                # K1b, K2b, K3b and K4b sum in a fixed order: a second call
                # gives the same bits
                same = (all(torch.equal(a, b) for a, b in
                            zip(got, fns["bwd"](ff, outs, grad, ws, mask)))
                        if persistent_bwd else True)
                torch.cuda.synchronize()
                e = {n: (a - b).abs().max().item()
                     for n, a, b in zip(fns["grads"], got, want)}
                du_max = {n: b.abs().max().item()
                          for n, b in zip(fns["grads"], want) if n.startswith("du")}
                ms = median_ms(lambda: fns["bwd"](ff, outs, grad, ws, mask), 5)
                plain_ms = median_ms(
                    lambda: fns["bwd_ref"](ff, outs, grad, ws, mask), 3)
                k2_ms = (median_ms(lambda: mod.lstm_recurrence_bwd(
                    ff, *outs, grad, *ws, mask), 3) if lean
                    else _k2b_ms(mods["lstm"], T, B, H)
                    if cell == "gru" and act is None else None)
                # K4b's dU, the float32 GEMM after its two launches, alone
                h_prev = outs[0][:-1].reshape(-1, H)
                du_ms = (median_ms(lambda: h_prev.t() @ got[0][1:].reshape(
                    -1, 4 * H), 5) if lean else None)
            atol = LEAN_BWD_ATOL if lean else KERNEL_ATOL
            rtol = LEAN_DU_RTOL if lean else DU_RTOL
            print(f"kernel {label} T={T} B={B} H={H}: max_abs_err dff="
                  f"{e['dff']:.3e} dmask={e['dmask']:.3e} (atol "
                  f"{atol:g}), " + ", ".join(
                      f"{n}={e[n]:.3e} of max|{n}| {du_max[n]:.3f}"
                      for n in du_max)
                  + f" (rtol {rtol:g}); kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms"
                  + (f", K2b at this shape {k2_ms:.3f} ms"
                     if k2_ms is not None else ""),
                  flush=True)
            if persistent_bwd:
                plan = (mod.lean_bwd_plan if lean else mod.bwd_plan)(B, H)
                # K1b streams dA; K2b, K3b and K4b exchange partial sums
                staged = (f"{plan['chunk']} units' dA pairs staged at a time, "
                          f"{4 * plan['dabuf_floats']} bytes of dA buffer"
                          if cell == "ligru" else
                          f"{plan['chunk']} blocks of partial sums staged at a "
                          f"time, {4 * plan['pbuf_floats']} bytes of "
                          "partial-sum buffer")
                print(f"kernel {label} T={T} B={B} H={H}: {1e3 * ms / T:.2f} us "
                      f"per step (the whole call)"
                      + (f", of which the dU GEMM alone {du_ms:.3f} ms"
                         if lean else "") + "; sequential grid P="
                      f"{plan['ctas']} CTAs of u={plan['units']} units"
                      + (f" in {plan['groups']} groups of {plan['group_ctas']}"
                         if lean else "") + ", "
                      f"{plan['smem_bytes']} shared-memory bytes a CTA, "
                      f"{staged}; repeat bitwise equal: {same}", flush=True)
            check(same, f"{label}: two calls differ at {(T, B, H)}")
            check(all(math.isfinite(v) for v in e.values()),
                  f"{label}: non-finite error at {(T, B, H)}")
            check(e["dff"] <= atol and e["dmask"] <= atol,
                  f"{label} dff/dmask disagree at {(T, B, H)}: {e}")
            for n, mx in du_max.items():
                check(e[n] <= rtol * mx,
                      f"{label} {n} disagrees at {(T, B, H)}: {e[n]} of {mx}")
            errs[name] = max(errs.get(name, 0.0), *e.values())
            if act is None:  # the kernels line times the recipe's act
                timing[(name, T, B, H)] = (ms, plain_ms)
            if name in ("lstm_bwd", "lstm_lean_bwd") and name not in library:
                dtype = torch.bfloat16 if lean else torch.float32
                lib_ms, lib_err = library_bwd_ms(mod, ff, ws[0], grad, dtype)
                library[name] = (lib_ms, T, B, H)
                print(f"library {name} T={T} B={B} H={H}: cuDNN LSTM backward "
                      f"({str(dtype)[6:]}, input and weight_hh_l0 gradients) "
                      f"{lib_ms:.3f} ms; its input gradient vs the kernel's dff "
                      f"at mask 1: max_abs_err={lib_err:.3e}", flush=True)

        # autograd through the Function (forward kernel, then backward
        # kernel) against autograd through the plain loop, at a small shape;
        # 1e-5: float32, sums in other orders.  The GRU in both activations.
        # The bf16-U Function against its plain backward on its own forward
        # outputs (the same h and c, so no forward drift).
        for act in (("relu", "tanh") if cell == "gru" else (None,)):
            f = _cell_fns(cell, mod, act)
            ff, ws, mask, grad = _recurrence_inputs(cell, 50, 4, 64, 7)
            grads = []
            leaves = [x.clone().requires_grad_() for x in (ff, *ws)]
            (f["fn"](*leaves, mask) * grad).sum().backward()
            grads.append([x.grad for x in leaves])
            if lean:
                with torch.inference_mode():
                    outs = f["fwd"](ff, ws, mask)
                    grads.append(f["bwd_ref"](ff, outs, grad, ws, mask)[:2])
            else:
                leaves = [x.clone().requires_grad_() for x in (ff, *ws)]
                (f["loop"](*leaves, mask) * grad).sum().backward()
                grads.append([x.grad for x in leaves])
            torch.cuda.synchronize()
            ag_err = max((x - y).abs().max().item() for x, y in zip(*grads))
            label = f"{cell}" + (f" {act}" if act else "")
            against = "plain backward" if lean else "plain loop"
            print(f"kernel autograd ({label} Function vs {against}, T=50 B=4 "
                  f"H=64): max_abs_err={ag_err:.3e} (atol 1e-5)", flush=True)
            check(ag_err <= 1e-5, f"{label} Function gradients disagree: {ag_err}")
    return {"errs": errs, "timing": timing, "library": library,
            "library_wide": library_wide}


def conv_bound_ms(name, N, L, K, O, pool, residuals=True, need_dx=True):
    """(least ms the card could take for one call, "bytes" or "operations"):
    each input read and each output written once at the memory's peak,
    against the float32 multiply-adds at the float32 peak.  The forwards
    convolve every position, 2 N (L-K+1) K O flops; a backward needs only
    the pooled rows' gradients, dW 2 N M K O and, with `need_dx`, dX as
    many again (reading w and writing dx); K6b reads K6f's pooled value
    (ypool) and recomputes none.  `residuals`: the forwards' idx (and K6f's
    stats and ypool) are written (training)."""
    Lc = L - K + 1
    M = Lc // pool
    nmo = N * M * O
    bwd_flops = (4 if need_dx else 2) * N * M * K * O
    flops = {"conv_pool_fwd": 2 * N * Lc * K * O, "conv_ln_fwd": 2 * N * Lc * K * O,
             "conv_pool_bwd": bwd_flops, "conv_ln_bwd": bwd_flops}
    x, w = 4 * N * L, 4 * K * O
    idx = nmo if residuals else 0
    stats = 8 * N * O if residuals else 0
    ypool = 4 * nmo if residuals else 0
    ln_in = 4 * O + 8 * M * O  # bias, gt, bt
    dx = w + x if need_dx else 0  # w read, dx written
    nbytes = {
        "conv_pool_fwd": x + w + 4 * nmo + idx,
        "conv_pool_bwd": x + 4 * nmo + nmo + dx + w,
        "conv_ln_fwd": x + w + ln_in + 4 * nmo + idx + stats + ypool,
        "conv_ln_bwd": x + ln_in + nmo + 8 * N * O + 4 * nmo + 4 * nmo
                       + dx + w + ln_in,
    }
    bytes_ms = nbytes[name] / PEAK_BYTES * 1e3
    ops_ms = flops[name] / PEAK_FLOPS["f32"] * 1e3
    return (bytes_ms, "bytes") if bytes_ms > ops_ms else (ops_ms, "operations")


def _conv_composite(F, x, w, bias, gt, bt, pool, eps, ln):
    """The library yardstick: one cuDNN conv (F.conv1d) and
    F.max_pool1d(return_indices=True), plus, for K6, the bias, the layer
    norm over time (the reference's unbiased std, eps on the std) and relu
    as PyTorch ops; (N, O, M)."""
    y, _ = F.max_pool1d(F.conv1d(x[:, None, :], w.t()[:, None, :]), pool,
                        return_indices=True)
    if not ln:
        return y
    y = y + bias[None, :, None]
    mu = y.mean(2, keepdim=True)
    std = torch.sqrt(((y - mu) ** 2).sum(2, keepdim=True) / (y.shape[2] - 1))
    return torch.relu((y - mu) / (std + eps) * gt.t() + bt.t())


def _conv_inputs(N, L, K, O, pool, seed):
    g = torch.Generator().manual_seed(seed)
    M = (L - K + 1) // pool
    x = torch.randn(N, L, generator=g)
    w = torch.randn(K, O, generator=g) / K ** 0.5
    bias = torch.randn(O, generator=g)
    gt = 1 + 0.3 * torch.randn(M, O, generator=g)
    bt = 0.3 * torch.randn(M, O, generator=g)
    dy = torch.randn(N, M, O, generator=g)
    return [t.cuda() for t in (x, w, bias, gt, bt, dy)]


def _fwd_geometry(conv1d, name, N, L, K, O, pool) -> str:
    """K5f's or K6f's tile and launch at a shape (`conv1d.fwd_plan`)."""
    source = conv1d.SOURCE if name == "conv_pool_fwd" else conv1d.LN_SOURCE
    p = conv1d.fwd_plan(source, N, L, K, O, pool)
    return (f"tile {p['positions']} positions x {p['filters_per_thread']} "
            f"filters a conv thread, {p['filters']} filters and "
            f"{p['threads']} threads a block, {p['items']} items on a grid "
            f"of {p['grid']}, {p['smem_bytes']} B shared, {p['buffers']} "
            f"pooled-row buffers, {p['blocks_per_sm']} blocks per SM"
            + (f", {p['rows']} rows an item, {p['row_blocks']} row blocks a "
               f"window" if "rows" in p else ""))


def conv_kernel_phase(conv1d) -> dict:
    """K5f/K5b and K6f/K6b against their plain versions: at the training
    batch for O = 80 and 128 (K6 also at drop 0.15, where kernel and plain
    version must drop the same elements), at an odd shape, and K5f/K6f on
    the serving batch (a slice of its windows held to the plain version),
    their argmax flips against the plain version's at most CONV_MAX_FLIPS
    and each one's tile and launch printed beside its time.  The
    backwards are held given the kernel's own idx (K6b also its own
    ypool): a sum in another order can flip a near-tie argmax, which moves
    a gradient to the neighbouring sample; each with dX and without (for
    a layer 0 whose input needs no gradient), whose other gradients must be
    bitwise those with dX, and twice, bitwise equal; then
    `conv_fwd_edges`.  The same at SincNet's published 251 taps
    (CONV_251: K5 at O = 80, K6 at 128, also with dropout) and at a pool
    of 16 (CONV_LONG_POOL).  Times: median of 5 launches, the plain
    version's of 3, the library composite's of 3.  Returns {kernel name:
    record} at the recipe's shape (K5 at O = 80, K6 at O = 128; the
    backwards with dX, as the raw recipes run them: their input layer norm
    trains a gain and a shift), with the times at 251 taps as `k251_*`."""
    import torch.nn.functional as F

    N, L, K, pool = CONV_TRAIN
    eps, seed = 1e-6, -12345
    rec = {}
    # (relu off, a linear layer 0, at the odd shape without dropout)
    shapes = [(N, L, K, O, pool, drop, True) for O in (80, 128)
              for drop in (0.0, CONV_DROP)] + [(*CONV_ODD, 0.0, False),
                                               (*CONV_ODD, CONV_DROP, True),
                                               (*CONV_FBANK, CONV_DROP, True)]
    # SincNet's 251 taps (K5 at 80 filters, K6 at 128, also with dropout)
    # and a pool of 16
    n251, l251, k251, p251 = CONV_251
    shapes += [(n251, l251, k251, 80, p251, 0.0, True),
               (n251, l251, k251, 128, p251, 0.0, True),
               (n251, l251, k251, 128, p251, CONV_DROP, True),
               (*CONV_LONG_POOL, 0.0, True)]
    for n_, l_, k_, o_, p_, drop, relu in shapes:
        x, w, bias, gt, bt, dy = _conv_inputs(n_, l_, k_, o_, p_, n_ + o_)
        tag = f"N={n_} L={l_} K={k_} O={o_} pool={p_}"
        train = (n_, l_, k_, p_) == CONV_TRAIN
        long_taps = (n_, l_, k_, p_) == CONV_251
        with torch.inference_mode():
            got, same = {}, {}
            if drop == 0.0:
                y, idx = conv1d.conv1d_pool(x, w, p_)
                y_r, idx_r = conv1d.conv1d_pool_ref(x, w, p_)
                g5 = [conv1d.conv1d_pool_bwd(x, dy, idx, w, p_, need)
                      for need in (True, False, True)]
                dx_r, dw_r = conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, p_)
                torch.cuda.synchronize()
                got["conv_pool_fwd"] = ((y - y_r).abs().max().item(),
                                        (idx != idx_r).sum().item())
                got["conv_pool_bwd"] = max(
                    ((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(g5[0], (dx_r, dw_r)))
                same["conv_pool_bwd"] = (
                    g5[1][0] is None and torch.equal(g5[1][1], g5[0][1]),
                    all(torch.equal(a, b) for a, b in zip(g5[0], g5[2])))
                del g5
            ln = (x, w, bias, gt, bt, seed, p_, eps, relu, drop)
            z, idx6, stats, ypool = conv1d.conv1d_pool_ln_act(*ln)
            z_r, idx6_r, stats_r = conv1d.conv1d_pool_ln_act_ref(*ln)
            y6 = conv1d._pooled_at(conv1d._conv(x, w), idx6, p_)
            res6 = (idx6, stats, ypool, dy)
            gk = [conv1d.conv1d_pool_ln_act_bwd(*ln[:6], *res6, *ln[6:], need)
                  for need in (True, False, True)]
            gr = conv1d.conv1d_pool_ln_act_bwd_ref(*ln[:6], idx6, stats, dy,
                                                   *ln[6:])
            torch.cuda.synchronize()
            # the hash mask exactly: no element it drops is nonzero in the
            # kernel's output, and none it keeps is 0 where the plain
            # output is not (beyond CONV_ATOL of 0, where relu's gate may
            # fall either way)
            keep = conv1d.drop_mask(seed, torch.arange(n_, device=z.device),
                                    z.shape[1], o_, drop) if drop else None
            dropped = (((~keep & (z != 0))
                        | (keep & (z == 0) & (z_r.abs() > CONV_ATOL)))
                       .sum().item() if drop else 0)
            del keep
            got["conv_ln_fwd"] = (max((z - z_r).abs().max().item(),
                                      (stats - stats_r).abs().max().item(),
                                      (ypool - y6).abs().max().item()),
                                  (idx6 != idx6_r).sum().item())
            check(torch.equal(gk[0][2], torch.zeros_like(bias)),
                  f"conv_ln_bwd: dbias is not an exact zero at {tag}")
            got["conv_ln_bwd"] = max(
                ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for i, (a, b) in enumerate(zip(gk[0], gr)) if i != 2)
            same["conv_ln_bwd"] = (
                gk[1][0] is None and all(torch.equal(a, b)
                                         for a, b in zip(gk[1][1:], gk[0][1:])),
                all(torch.equal(a, b) for a, b in zip(gk[0], gk[2])))
            del gk, y6
        for name, e in got.items():
            fwd = name.endswith("_fwd")
            err = e[0] if fwd else e
            tol = CONV_ATOL if fwd else CONV_GRAD_RTOL
            print(f"kernel {name} {tag} drop={drop}"
                  + ("" if relu or not name.startswith("conv_ln") else
                     " linear") + ": "
                  + (f"max_abs_err={err:.3e} (atol {tol:g})"
                     + (" over out, stats and ypool"
                        if name == "conv_ln_fwd" else "")
                     + f", argmax differs at {e[1]} of {z.numel()} (at most "
                       f"{CONV_MAX_FLIPS})" if fwd else
                     f"max_rel_err={err:.3e} of each gradient's max (rtol "
                     f"{tol:g}), given the kernel's idx; without dX the rest "
                     f"bitwise equal: {same[name][0]}; repeat bitwise equal: "
                     f"{same[name][1]}")
                  + (f", dropped elements differ at {dropped}"
                     if name == "conv_ln_fwd" and drop else ""), flush=True)
            check(math.isfinite(err) and err <= tol,
                  f"{name} disagrees with its plain version at {tag}: {err}")
            if fwd:
                check(e[1] <= CONV_MAX_FLIPS, f"{name}'s argmax differs from "
                      f"its plain version's at {e[1]} elements at {tag}")
            else:
                check(all(same[name]), f"{name} at {tag}: without dX or on a "
                      f"repeat, the gradients are not bitwise the same")
            r = rec.setdefault(name, {"err": 0.0})
            r["err"] = max(r["err"], err)
        if drop:
            check(dropped == 0, f"conv_ln_fwd drops other elements at {tag}")
        if (n_, l_, k_, o_, p_) == CONV_FBANK:
            # CNN_fbank's layer 0 in training (no recipe run of it here);
            # its input, spliced features, needs no gradient.  A call here
            # is short, so the host's share is much of its time alone: K6f
            # also on the device alone, its seed a tensor on the card as
            # the recipes pass it (an int's copy would wait for the queue)
            seed_t = torch.tensor(seed, dtype=torch.int32, device="cuda")
            dev_ms = queued_ms(lambda: conv1d.conv1d_pool_ln_act(
                *ln[:5], seed_t, *ln[6:]))
            times = [(median_ms(lambda: conv1d.conv1d_pool_ln_act(*ln), 5),
                      conv_bound_ms("conv_ln_fwd", n_, l_, k_, o_, p_)[0]),
                     (median_ms(lambda: conv1d.conv1d_pool_ln_act_bwd(
                         *ln[:6], *res6, *ln[6:], False), 5),
                      conv_bound_ms("conv_ln_bwd", n_, l_, k_, o_, p_,
                                    need_dx=False)[0])]
            print(f"kernel conv_ln_fwd/conv_ln_bwd at cfg/TIMIT/CNN_fbank.cfg's "
                  f"layer 0 {tag} drop={drop}: K6f {times[0][0]:.3f} ms "
                  f"({dev_ms:.4f} ms a call on the device alone; bound "
                  f"{times[0][1]:.4f} ms; "
                  f"{_fwd_geometry(conv1d, 'conv_ln_fwd', n_, l_, k_, o_, p_)}"
                  f"), K6b without dX {times[1][0]:.3f} ms "
                  f"(bound {times[1][1]:.4f} ms)", flush=True)
        if not (train or long_taps) or drop:
            continue
        # times at the training batch (K = 129, and SincNet's 251), and
        # the library composites; the backwards with dX (the recipes'
        # path, recorded) and without
        for name, kernel, plain in (
                ("conv_pool_fwd", lambda _: conv1d.conv1d_pool(x, w, p_),
                 lambda _: conv1d.conv1d_pool_ref(x, w, p_)),
                ("conv_pool_bwd",
                 lambda nd: conv1d.conv1d_pool_bwd(x, dy, idx, w, p_, nd),
                 lambda nd: conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, p_, nd)),
                ("conv_ln_fwd", lambda _: conv1d.conv1d_pool_ln_act(*ln),
                 lambda _: conv1d.conv1d_pool_ln_act_ref(*ln)),
                ("conv_ln_bwd", lambda nd: conv1d.conv1d_pool_ln_act_bwd(
                    *ln[:6], *res6, *ln[6:], nd),
                 lambda nd: conv1d.conv1d_pool_ln_act_bwd_ref(
                    *ln[:6], idx6, stats, dy, *ln[6:], nd))):
            use_ln = name.startswith("conv_ln")
            fwd = name.endswith("_fwd")
            for need_dx in ((True,) if fwd else (True, False)):
                ms = median_ms(lambda: kernel(need_dx), 5)
                plain_ms = median_ms(lambda: plain(need_dx), 3)
                if fwd:
                    with torch.no_grad():
                        lib_ms = median_ms(lambda: _conv_composite(
                            F, x, w, bias, gt, bt, p_, eps, use_ln), 3)
                else:
                    lib_in = [t.clone().requires_grad_(i > 0 or need_dx)
                              for i, t in enumerate((x, w, bias, gt, bt))]
                    out = _conv_composite(F, *lib_in, p_, eps, use_ln)
                    g = dy.transpose(1, 2)
                    leaves = [t for t in (lib_in if use_ln else lib_in[:2])
                              if t.requires_grad]
                    lib_ms = median_ms(lambda: torch.autograd.grad(
                        out, leaves, g, retain_graph=True), 3)
                    del out, lib_in
                bound, by = conv_bound_ms(name, n_, l_, k_, o_, p_,
                                          need_dx=need_dx)
                print(f"kernel {name} N={n_} L={l_} K={k_} O={o_} pool={p_}"
                      + ("" if fwd else
                         f" {'with' if need_dx else 'without'} dX")
                      + f": kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                      f"library composite {lib_ms:.3f} ms, bound {bound:.3f} "
                      f"ms ({by})"
                      + (f"; {_fwd_geometry(conv1d, name, n_, l_, k_, o_, p_)}"
                         if fwd else ""), flush=True)
                own = o_ == (80 if name.startswith("conv_pool") else 128)
                if own and need_dx and train:
                    rec[name].update(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound,
                                     bound_by=by, shape=(n_, l_, k_, o_, p_))
                elif own and need_dx:
                    rec[name].update(k251_ms=ms, k251_plain_ms=plain_ms,
                                     k251_library_ms=lib_ms,
                                     k251_bound_ms=bound, k251_bound_by=by)
    # the serving batch: the forwards alone (no idx, no stats)
    for name, O in (("conv_pool_fwd", 80), ("conv_ln_fwd", 128)):
        M = (L - K + 1) // pool
        x, w, bias, gt, bt, _ = _conv_inputs(1, L, K, O, pool, O)
        x = torch.randn(CONV_SERVE_N, L, device="cuda")
        if name == "conv_pool_fwd":
            kernel = lambda xx: conv1d.conv1d_pool(xx, w, pool,  # noqa: E731
                                                   need_idx=False)[0]
            plain = lambda xx: conv1d.conv1d_pool_ref(xx, w, pool)[0]  # noqa: E731
        else:
            kernel = lambda xx: conv1d.conv1d_pool_ln_act(  # noqa: E731
                xx, w, bias, gt, bt, 0, pool, eps, True, 0.0, residuals=False)[0]
            plain = lambda xx: conv1d.conv1d_pool_ln_act_ref(  # noqa: E731
                xx, w, bias, gt, bt, 0, pool, eps, True, 0.0)[0]
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            out = kernel(x)
            n = CONV_SERVE_CHECK
            err = max((out[sl] - plain(x[sl])).abs().max().item()
                      for sl in (slice(0, n), slice(-n, None)))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            del out
            ms = median_ms(lambda: kernel(x), 5)
            xs = x[:CONV_SERVE_PLAIN_N]
            plain_ms = median_ms(lambda: plain(xs), 3)
        bound, by = conv_bound_ms(name, CONV_SERVE_N, L, K, O, pool, False)
        print(f"kernel {name} serving N={CONV_SERVE_N} L={L} K={K} O={O} "
              f"pool={pool}: max_abs_err={err:.3e} on {2 * n} windows (atol "
              f"{CONV_ATOL:g}); kernel {ms:.3f} ms ({M * O * 4 * CONV_SERVE_N / 1e9:.2f}"
              f" GB out, peak {peak:.2f} GiB), bound {bound:.3f} ms ({by}); "
              f"plain at N={CONV_SERVE_PLAIN_N} {plain_ms:.3f} ms; "
              f"{_fwd_geometry(conv1d, name, CONV_SERVE_N, L, K, O, pool)}",
              flush=True)
        check(math.isfinite(err) and err <= CONV_ATOL,
              f"{name} disagrees with its plain version at serving: {err}")
        rec[name]["err"] = max(rec[name]["err"], err)
        del x
    torch.cuda.empty_cache()
    conv_fwd_edges(conv1d)
    return rec


def conv_fwd_edges(conv1d) -> None:
    """K5f and K6f at forced ties (CONV_TIES: the argmax exactly the plain
    version's, the pooled values its bits, out within CONV_ATOL) and on
    their launch's other paths (CONV_LONG_K5, CONV_LONG_K6: within
    CONV_ATOL, argmax flips at most CONV_MAX_FLIPS), each with its
    launch printed."""
    eps, seed = 1e-6, -12345
    for n_, l_, k_, o_, p_ in CONV_TIES:
        tag = f"N={n_} L={l_} K={k_} O={o_} pool={p_}"
        g = torch.Generator().manual_seed(n_ + l_)
        x = torch.randint(-1, 2, (n_, l_), generator=g).float().cuda()
        w = torch.randint(-1, 2, (k_, o_), generator=g).float().cuda()
        _, _, bias, gt, bt, _ = _conv_inputs(n_, l_, k_, o_, p_, n_ + l_)
        ln = (x, w, bias, gt, bt, seed, p_, eps, True, 0.0)
        with torch.inference_mode():
            c = conv1d._conv(x, w)
            M = c.shape[1] // p_
            c4 = c[:, :M * p_].reshape(n_, M, p_, o_)
            ties = ((c4 == c4.amax(2, keepdim=True)).sum(2) > 1).sum().item()
            y, idx = conv1d.conv1d_pool(x, w, p_)
            y_r, idx_r = conv1d.conv1d_pool_ref(x, w, p_)
            z, idx6, _, ypool = conv1d.conv1d_pool_ln_act(*ln)
            z_r, idx6_r, _ = conv1d.conv1d_pool_ln_act_ref(*ln)
            flips = ((idx != idx_r).sum().item(), (idx6 != idx6_r).sum().item())
            exact = torch.equal(y, y_r) and torch.equal(ypool, y_r)
            err = (z - z_r).abs().max().item()
        print(f"kernel conv_pool_fwd/conv_ln_fwd at forced ties {tag}: "
              f"{ties} of {idx.numel()} pooled values reached twice or more; "
              f"argmax differs at {flips[0]} (K5f) and {flips[1]} (K6f), "
              f"must be 0; pooled values bitwise the plain version's: "
              f"{exact}; K6f max_abs_err={err:.3e} (atol {CONV_ATOL:g}); K5f "
              f"{_fwd_geometry(conv1d, 'conv_pool_fwd', n_, l_, k_, o_, p_)}"
              f"; K6f {_fwd_geometry(conv1d, 'conv_ln_fwd', n_, l_, k_, o_, p_)}",
              flush=True)
        check(ties > 0 and flips == (0, 0) and exact and err <= CONV_ATOL,
              f"K5f/K6f at forced ties {tag}: argmax flips {flips}, pooled "
              f"values exact {exact}, K6f error {err}")
    for name, (n_, l_, k_, o_, p_) in (("conv_pool_fwd", CONV_LONG_K5),
                                       ("conv_ln_fwd", CONV_LONG_K6)):
        tag = f"N={n_} L={l_} K={k_} O={o_} pool={p_}"
        x, w, bias, gt, bt, _ = _conv_inputs(n_, l_, k_, o_, p_, n_ + l_)
        with torch.inference_mode():
            if name == "conv_pool_fwd":
                y, idx = conv1d.conv1d_pool(x, w, p_)
                y_r, idx_r = conv1d.conv1d_pool_ref(x, w, p_)
                err = (y - y_r).abs().max().item()
            else:
                ln = (x, w, bias, gt, bt, seed, p_, eps, True, CONV_DROP)
                y, idx, stats, ypool = conv1d.conv1d_pool_ln_act(*ln)
                y_r, idx_r, stats_r = conv1d.conv1d_pool_ln_act_ref(*ln)
                y6 = conv1d._pooled_at(conv1d._conv(x, w), idx, p_)
                err = max((y - y_r).abs().max().item(),
                          (stats - stats_r).abs().max().item(),
                          (ypool - y6).abs().max().item())
            flips = (idx != idx_r).sum().item()
        print(f"kernel {name} {tag}: max_abs_err={err:.3e} (atol "
              f"{CONV_ATOL:g}), argmax differs at {flips} of {idx.numel()} "
              f"(at most {CONV_MAX_FLIPS}); "
              f"{_fwd_geometry(conv1d, name, n_, l_, k_, o_, p_)}", flush=True)
        check(math.isfinite(err) and err <= CONV_ATOL
              and flips <= CONV_MAX_FLIPS,
              f"{name} at {tag}: error {err}, argmax flips {flips}")


def stack_bound_ms(name, N, L, len_filt, n_filt, pools, residuals=True):
    """(least ms the card could take for one call of the whole conv stack,
    "bytes" or "operations"), counted as `conv_bound_ms` counts a layer:
    layer 0's forward convolves every position, an upper layer's the ct =
    M * pool rows its pool reads, 2 N rows C K O flops each; a layer's
    backward needs only the pooled rows, dW and dX, 4 N M C K O flops, on
    the pooled value its forward kept (K6f's ypool for layer 0, and since
    K7b stopped recomputing it, K7f's y for each upper layer).  Bytes: x,
    every layer's weights, bias and affine maps read once; the forward
    writes the output and, with `residuals` (training), every layer's
    output (the next layer's kept input), idx, stats and pooled value; the
    backward reads those and dz, and writes dx and every gradient."""
    fwd = name == "conv_stack_fwd"
    nbytes = 4 * N * L * (1 if fwd else 2)
    flops, C, lin = 0, 1, L
    for i, (K, O, P) in enumerate(zip(len_filt, n_filt, pools)):
        M = (lin - K + 1) // P
        nmo = N * M * O
        params = 4 * (C * K * O + O + 2 * M * O)
        res = nmo + 8 * N * O + 4 * nmo  # idx, stats, the pooled value
        last = i == len(n_filt) - 1
        if fwd:
            flops += 2 * N * ((lin - K + 1) if i == 0 else M * P) * C * K * O
            nbytes += params + (4 * nmo if residuals or last else 0) + (
                res if residuals else 0)
        else:
            flops += 4 * N * M * C * K * O
            nbytes += 2 * params + res + (4 * N * lin * C if i else 0) + (
                4 * nmo if last else 0)
        C, lin = O, M
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = flops / PEAK_FLOPS["f32"] * 1e3
    return (bytes_ms, "bytes") if bytes_ms > ops_ms else (ops_ms, "operations")


def _cnn_raw_stack():
    """CNN_raw's conv stack as its cfg gives it: the cnn_* fields of the
    architecture named CNN_layers."""
    import configparser

    cp = configparser.ConfigParser()
    cp.read(os.path.join(REPO, "cfg", "TIMIT", "CNN_raw.cfg"))
    sec = next(cp[s] for s in cp.sections()
               if cp[s].get("arch_name") == "CNN_layers")
    return {k: v for k, v in sec.items() if k.startswith("cnn_")}


def _stack_inputs(geo, N, n_filt, seed):
    """x, w0, bias0, gt0, bt0, the upper layers and a gradient of the
    output, on the card (weights at nn.Conv1d's scale, affine maps near 1
    and 0)."""
    g = torch.Generator().manual_seed(seed)
    L, K0, M0, O0 = geo[0][0], geo[0][1], geo[0][4], n_filt[0]
    x = torch.randn(N, L, generator=g)
    w0 = torch.randn(K0, O0, generator=g) / K0 ** 0.5
    first = [x, w0, torch.randn(O0, generator=g),
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


def _stack_grads(g):
    """The stack backward's gradients as a flat list, names beside."""
    names = ["dx", "dw0", "dbias0", "dgt0", "dbt0"] + [
        f"{n}{i}" for i in range(1, len(g[5]) + 1)
        for n in ("dW", "dbias", "dgamma", "dbeta")]
    return names, [*g[:5], *(t for u in g[5] for t in u)]


def _per_layer_cnn(opts, L, first, ups):
    """The port's per-layer path over the same weights: `CNN` at
    TPUKALDI_CONV_IMPL=pallas (K6 for layer 0, then cuDNN's conv,
    F.max_pool1d, the layer norm and relu), in eval mode, without the input
    layer norm and the dropout (the stack takes neither)."""
    from tpukaldi_torch.models import CNN

    n = len(ups) + 1
    with _env(TPUKALDI_CONV_IMPL="pallas"):
        cnn = CNN({**opts, "cnn_use_laynorm_inp": "False",
                   "cnn_drop": ",".join(["0.0"] * n)}, L, device="cuda").eval()
    x, w0, bias0, gt0, bt0 = first
    with torch.no_grad():
        cnn.conv[0].weight.copy_(w0.t()[:, None, :])
        cnn.conv[0].bias.copy_(bias0)
        cnn.ln[0].gamma.copy_(gt0.t())
        cnn.ln[0].beta.copy_(bt0.t())
        for i, (kernel, b, g, be) in enumerate(ups, 1):
            cnn.conv[i].weight.copy_(kernel)
            cnn.conv[i].bias.copy_(b)
            cnn.ln[i].gamma.copy_(g.t())
            cnn.ln[i].beta.copy_(be.t())
    return cnn


def stack_phase(modules) -> dict:
    """K7f/K7b (the whole conv stack, layer 0 through K6) at CNN_raw's stack
    shapes: against their plain versions at the training batch, at drop 0
    and at the recipe's 0.15 (the same dropped elements in every layer;
    every layer's output, stats, argmax and kept pooled value y), the
    backward given the kernel's own residuals and bitwise equal to itself
    on a second call (no atomics); K7f at drop 0 against the
    port's per-layer path; times, bounds and the per-layer path as the
    yardstick, at the training and the serving batch (peak memory beside);
    then the stack's own path, counted: STACK_STEPS training steps through
    `conv_stack_fused` with dropout seeds drawn on the card, and one
    forward without a gradient.  Returns {kernel name: record}."""
    from tpukaldi_torch.train import chunk_runtime

    cs, conv1d = modules["conv_stack"], modules["conv1d"]
    opts = _cnn_raw_stack()
    n_filt, len_filt, pools = (
        tuple(int(v) for v in opts[f"cnn_{k}"].split(","))
        for k in ("n_filt", "len_filt", "max_pool_len"))
    check(set(opts["cnn_act"].split(",")) == {"relu"},
          f"CNN_raw's stack is expected all relu: {opts['cnn_act']}")
    drops = tuple(float(d) for d in opts["cnn_drop"].split(","))
    no_drop = (0.0,) * len(n_filt)
    L, N, eps, seed = TREES["RAW"]["dim"], STACK_TRAIN_N, 1e-6, -12345
    geo = cs.stack_geometry(L, len_filt, pools)
    first, ups, dz = _stack_inputs(geo, N, n_filt, 17)
    tag = (f"N={N} L={L} K={len_filt} filters={n_filt} pools={pools} "
           f"(M={tuple(g[4] for g in geo)})")
    rec = {name: {"err": 0.0} for name in STACK_KERNELS}
    for d in (no_drop, drops):
        a = (*first, ups, seed, pools, eps, True, d)
        with torch.inference_mode():
            out, idx0, stats0, ypool0, res = cs.conv_stack_fwd(*a)
            ref = cs.conv_stack_ref(*a)
            gk = cs.conv_stack_bwd(*first, ups, seed, idx0, stats0, ypool0,
                                   res, dz, pools, eps, True, d)
            gk2 = cs.conv_stack_bwd(*first, ups, seed, idx0, stats0, ypool0,
                                    res, dz, pools, eps, True, d)
            gr = cs.conv_stack_bwd_ref(*first, ups, seed, idx0, stats0, res,
                                       dz, pools, eps, True, d)
            gp = cs.conv_stack_bwd_ref(*first, ups, seed, *ref[1:], dz, pools,
                                       eps, True, d)
            torch.cuda.synchronize()
        # every output K7f keeps: each layer's map, its stats and its argmax
        maps = [(r[0], rr[0]) for r, rr in zip(res, ref[3])] + [
            (out, ref[0])]
        f_err = max((h - hr).abs().max().item() for h, hr in maps)
        y_err = max((r[3] - rr[3]).abs().max().item()
                    for r, rr in zip(res, ref[3]))
        s_err = max((a_[2] - b_[2]).abs().max().item()
                    for a_, b_ in zip(((None, idx0, stats0), *res),
                                      ((None, ref[1], ref[2]), *ref[3])))
        flips = [(idx0 != ref[1]).sum().item()] + [
            (a_[1] != b_[1]).sum().item() for a_, b_ in zip(res, ref[3])]
        dropped = sum(((h == 0) != (hr == 0)).sum().item() for h, hr in maps)
        names, got = _stack_grads(gk)
        _, want = _stack_grads(gr)
        repeat = all(torch.equal(a_, b_)
                     for a_, b_ in zip(got, _stack_grads(gk2)[1])
                     if a_ is not None)
        _, plain = _stack_grads(gp)
        rel = {n: ((g_ - w_).abs().max() / w_.abs().max().clamp_min(1e-30)).item()
               for n, g_, w_ in zip(names, got, want) if "dbias" not in n}
        worst = max(rel, key=rel.get)
        nrel = {n: ((g_ - p_).norm() / p_.norm().clamp_min(1e-30)).item()
                for n, g_, p_ in zip(names, got, plain) if "dbias" not in n}
        nworst = max(nrel, key=nrel.get)
        zeros = all(torch.equal(g_, torch.zeros_like(g_))
                    for n, g_ in zip(names, got) if "dbias" in n)
        print(f"kernel conv_stack_fwd {tag} drop={d[0]}: max_abs_err="
              f"{f_err:.3e} over every layer's output, stats {s_err:.3e}, "
              f"kept pooled value y {y_err:.3e} "
              f"(atol {STACK_ATOL:g}); argmax differs at {flips} of "
              f"{[g_[4] * N * o for g_, o in zip(geo, n_filt)]} per layer "
              f"(at most {STACK_MAX_FLIPS}); zero (dropped or relu) elements "
              f"differ at {dropped}", flush=True)
        print(f"kernel conv_stack_bwd {tag} drop={d[0]}: worst max_rel_err="
              f"{rel[worst]:.3e} ({worst}) of each gradient's max (rtol "
              f"{STACK_GRAD_RTOL:g}), given the kernel's residuals; against "
              f"the plain backward on the plain forward's residuals worst "
              f"norm_rel_err={nrel[nworst]:.3e} ({nworst}, rtol "
              f"{STACK_GRAD_NORM_RTOL:g}); dbias exact zeros {zeros}; a second "
              f"call bitwise equal (no atomics): {repeat}", flush=True)
        check(math.isfinite(f_err) and f_err <= STACK_ATOL,
              f"conv_stack_fwd disagrees with its plain version: {f_err}")
        check(math.isfinite(s_err) and s_err <= STACK_ATOL,
              f"conv_stack_fwd's stats disagree with the plain version's: "
              f"{s_err}")
        check(math.isfinite(y_err) and y_err <= STACK_ATOL,
              f"conv_stack_fwd's kept pooled value disagrees with the plain "
              f"version's: {y_err}")
        check(max(flips) <= STACK_MAX_FLIPS,
              f"conv_stack_fwd's argmax differs at {flips} elements per layer")
        check(all(math.isfinite(v) for v in rel.values())
              and rel[worst] <= STACK_GRAD_RTOL,
              f"conv_stack_bwd disagrees with its plain version: {rel}")
        check(all(math.isfinite(v) for v in nrel.values())
              and nrel[nworst] <= STACK_GRAD_NORM_RTOL,
              f"conv_stack_bwd on the kernel's residuals disagrees with the "
              f"plain backward on the plain forward's: {nrel}")
        check(zeros, "conv_stack_bwd: a conv bias's gradient is not exactly 0")
        check(repeat, "conv_stack_bwd: two calls on the same inputs differ")
        if d[0]:
            check(dropped == 0, "conv_stack_fwd drops other elements")
        rec["conv_stack_fwd"]["err"] = max(rec["conv_stack_fwd"]["err"], f_err,
                                           s_err, y_err)
        rec["conv_stack_bwd"]["err"] = max(rec["conv_stack_bwd"]["err"],
                                           rel[worst])
        del out, idx0, stats0, ypool0, res, ref, gk, gk2, gr, gp, got, want
        del plain
        del maps

    # K7f at drop 0 against the per-layer path (which the recipe runs)
    cnn = _per_layer_cnn(opts, L, first, ups)
    x = first[0]
    with torch.inference_mode():
        out = cs.conv_stack_fwd(*first, ups, 0, pools, eps, True, no_drop,
                                residuals=False)[0]
        lay = cnn(x)
        err = (out.transpose(1, 2).reshape(N, -1) - lay).abs().max().item()
    print(f"kernel conv_stack_fwd vs the per-layer path (CNN at "
          f"TPUKALDI_CONV_IMPL=pallas: K6f, then cuDNN conv, max-pool, layer "
          f"norm, relu) {tag} drop=0: max_abs_err={err:.3e} (atol "
          f"{STACK_ATOL:g})", flush=True)
    check(math.isfinite(err) and err <= STACK_ATOL,
          f"conv_stack_fwd disagrees with the per-layer path: {err}")

    # times at the training batch (the recipe's dropout), and the per-layer
    # path's forward and autograd backward as the yardstick
    with torch.inference_mode():
        a = (*first, ups, seed, pools, eps, True, drops)
        _, idx0, stats0, ypool0, res = cs.conv_stack_fwd(*a)
        kept = sum(r[0].numel() * 4 for r in res) / 1e6
        kept_y = sum(r[3].numel() * 4 for r in res) / 1e6
        tail = (res, dz, pools, eps, True, drops)
        b = (*first, ups, seed, idx0, stats0, ypool0, *tail)
        b_plain = (*first, ups, seed, idx0, stats0, *tail)
        timing = {
            "conv_stack_fwd": (median_ms(lambda: cs.conv_stack_fwd(*a), 5),
                               median_ms(lambda: cs.conv_stack_ref(*a), 3),
                               median_ms(lambda: cnn(x), 3)),
            "conv_stack_bwd": [median_ms(lambda: cs.conv_stack_bwd(*b), 5),
                               median_ms(lambda: cs.conv_stack_bwd_ref(*b_plain), 3)]}
    xl = x.clone().requires_grad_()
    leaves = [xl, *cnn.parameters()]
    lay = cnn(xl)
    g = dz.transpose(1, 2).reshape(N, -1)
    timing["conv_stack_bwd"].append(median_ms(lambda: torch.autograd.grad(
        lay, leaves, g, retain_graph=True), 3))
    del lay, xl, leaves
    for name, (ms, plain_ms, lib_ms) in timing.items():
        bound, by = stack_bound_ms(name, N, L, len_filt, n_filt, pools)
        rec[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=by)
        print(f"kernel {name} {tag} drop={drops[0]}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, per-layer path {lib_ms:.3f} ms, bound "
              f"{bound:.3f} ms ({by})", flush=True)
    print(f"kernel conv_stack_fwd keeps each upper layer's input and pooled "
          f"value for the backward: {kept:.1f} and {kept_y:.1f} MB at N={N}",
          flush=True)
    # where K7f's and K7b's time goes, by device kernel
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cs.conv_stack_fwd(*a)
            cs.conv_stack_bwd(*b)
        torch.cuda.synchronize()
    busy_us, per_op = _device_events(prof)
    for op, (cnt, us) in sorted(per_op.items(), key=lambda kv: -kv[1][1]):
        print(f"profile conv stack device op: {us / reps / 1e3:.3f} ms a "
              f"forward + backward ({us / busy_us:.1%}) x{cnt // reps} "
              f"{op[:90]}", flush=True)

    # the serving batch: the forward alone (no residuals), and the
    # per-layer path on the same windows
    xs = torch.randn(CONV_SERVE_N, L, device="cuda")
    serve = (ups, 0, pools, eps, True, no_drop)
    with torch.inference_mode():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = cs.conv_stack_fwd(xs, *first[1:], *serve, residuals=False)[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = STACK_SERVE_CHECK
        s_err = max((out[sl] - cs.conv_stack_ref(xs[sl], *first[1:], *serve)[0])
                    .abs().max().item() for sl in (slice(0, n), slice(-n, None)))
        del out
        ms = median_ms(lambda: cs.conv_stack_fwd(xs, *first[1:], *serve,
                                                 residuals=False), 3)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lay = cnn(xs)
        peak_lay = torch.cuda.max_memory_allocated() / 2 ** 30
        del lay
        lib_ms = median_ms(lambda: cnn(xs), 3)
    bound, by = stack_bound_ms("conv_stack_fwd", CONV_SERVE_N, L, len_filt,
                               n_filt, pools, residuals=False)
    print(f"kernel conv_stack_fwd serving N={CONV_SERVE_N} {tag[tag.index('L='):]}: "
          f"max_abs_err={s_err:.3e} on {2 * n} windows (atol {STACK_ATOL:g}); "
          f"kernel {ms:.3f} ms, peak {peak:.2f} GiB; per-layer path {lib_ms:.3f} "
          f"ms, peak {peak_lay:.2f} GiB (the CNN_raw serving run's whole peak "
          f"was 39.16 GiB on the same batch); bound {bound:.3f} ms ({by})",
          flush=True)
    check(math.isfinite(s_err) and s_err <= STACK_ATOL,
          f"conv_stack_fwd disagrees with its plain version at serving: {s_err}")
    del xs, cnn
    torch.cuda.empty_cache()

    # the stack's own path, counted
    x, w0, bias0, gt0, bt0 = first
    params = [t.clone().requires_grad_() for t in (w0, bias0, gt0, bt0)]
    up_params = [[t.clone().requires_grad_() for t in u] for u in ups]
    flat = params + [t for u in up_params for t in u]
    gen = torch.Generator(device="cuda").manual_seed(7)
    _reset_counts(modules, chunk_runtime)
    losses = []
    for _ in range(STACK_STEPS):
        step_seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen,
                                  device="cuda", dtype=torch.int32)
        out = cs.conv_stack_fused(x, *params, up_params, step_seed, pools, eps,
                                  True, drops)
        loss = (out * dz).sum()
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            for p, gr in zip(flat, grads):
                p -= 1e-3 * gr
        losses.append(loss.item())
        check(all(bool(torch.isfinite(gr).all()) for gr in grads),
              "the stack's path: a non-finite gradient")
        check(all(torch.equal(gr, torch.zeros_like(gr))
                  for gr in grads[1::4]), "the stack's path: a conv bias's "
              "gradient is not exactly 0")
    with torch.no_grad():
        served = cs.conv_stack_fused(x, *params, up_params, 0, pools, eps, True,
                                     no_drop)
    torch.cuda.synchronize()
    counts = _counts(modules)
    want = {"conv_stack_fwd": STACK_STEPS + 1, "conv_stack_bwd": STACK_STEPS,
            "conv_ln_fwd": STACK_STEPS + 1, "conv_ln_bwd": STACK_STEPS}
    check({k: n for k, n in counts.items() if n} == want,
          f"the stack's path launched {counts}, expected {want}")
    check(served.shape == (N, geo[-1][4], n_filt[-1])
          and bool(torch.isfinite(served).all()),
          f"the stack's output: {tuple(served.shape)}, finite "
          f"{bool(torch.isfinite(served).all())}")
    print(f"stack path: {STACK_STEPS} steps of conv_stack_fused at drop "
          f"{drops[0]} (losses {', '.join(f'{v:.4f}' for v in losses)}) and one "
          f"forward without a gradient, output {tuple(served.shape)} finite; "
          f"launches {counts['conv_stack_fwd']} K7f, {counts['conv_stack_bwd']} "
          f"K7b (with K6f {counts['conv_ln_fwd']}, K6b {counts['conv_ln_bwd']} "
          f"for layer 0), no other kernel", flush=True)
    for name in STACK_KERNELS:
        rec[name]["launches"] = counts[name]
    return rec


def _reset_counts(modules, chunk_runtime) -> None:
    for mod, counter, _, _ in KERNELS.values():
        setattr(modules[mod], counter, 0)
    chunk_runtime.train_batches = chunk_runtime.valid_batches = 0
    chunk_runtime.forward_batches = 0
    chunk_runtime.cache_chunks = chunk_runtime.host_chunks = 0
    chunk_runtime.host_reason = ""
    _reset_graph_counts(chunk_runtime)


def _counts(modules):
    return {name: getattr(modules[mod], counter)
            for name, (mod, counter, _, _) in KERNELS.items()}


def _check_only(counts, recipe, what):
    """No kernel but the recipe's own two launched in a path of it.
    Returns the stack kernels' counts (so 0) for the kernels line."""
    own = (RECIPES[recipe]["fwd"], RECIPES[recipe]["bwd"])
    others = {k: n for k, n in counts.items() if k not in own and n}
    check(not others, f"{what}: other kernels launched: {others}")
    return {name: counts[name] for name in STACK_KERNELS}


def _plain_path(recipe, modules):
    """The context a recipe's plain path runs in, and its label."""
    if recipe == "QLSTM":
        return plain_recurrences(modules["lstm"]), "the bf16-U plain versions"
    if _raw(recipe):
        return (_env(TPUKALDI_CONV_IMPL="nhc"),
                "TPUKALDI_CONV_IMPL=nhc, the composed path")
    return contextlib.nullcontext(), f"{RECIPES[recipe]['cell']}_impl=scan"


def _plain_replace(recipe):
    """cfg replacements of the plain path: `*_impl = scan` for a TIMIT
    recurrent recipe; none for the QLSTM and the raw recipes, whose plain
    path is a context (`_plain_path`)."""
    return {} if recipe == "QLSTM" or _raw(recipe) else _scan(recipe)


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


def _cpu_posteriors(ft, exp, names, impl=None):
    """The CPU path's posteriors of `names`; `impl` sets the QLSTM's
    `qlstm_impl` for the call (pallas: its bf16-U plain version)."""
    archs = [a for a in exp.archs.values() if a.class_name == "QLSTM"]
    saved = [a.options.get("qlstm_impl") for a in archs]
    for a in archs:
        if impl is not None:
            a.options["qlstm_impl"] = impl
    try:
        return ft.forward_utterances(exp, names, "cpu")
    finally:
        for a, v in zip(archs, saved):
            if v is None:
                a.options.pop("qlstm_impl", None)
            else:
                a.options["qlstm_impl"] = v


def _check_cpu_path(ft, exp, out, names, lengths, recipe,
                    float64=False) -> str:
    """Two utterances (shortest, longest) through the port's CPU path from
    the same final checkpoints; with `float64` (a path with no hand
    kernel, whose trained weights amplify float32 rounding) the same
    forward also runs in float64 on the card and on the CPU, held to each
    other within F64_PATHS_ATOL, and each float32 path's distance from the
    CPU's float64 run is printed beside.  The QLSTM's
    CUDA path multiplies bf16 operands, so its CPU path is the bf16-U
    plain version (`qlstm_impl = pallas` on CPU): the same arithmetic,
    summed in another order, whose rounding ties drift apart over the
    steps as in the kernel phase.  It is
    held to POSTERIOR_ATOL, or, where trained weights amplify that drift,
    to the distance between the CPU path's bf16 and float32 arithmetic (the
    scale of a bf16 operand's rounding), printed beside it."""
    wanted = sorted({names[lengths.index(min(lengths))],
                     names[lengths.index(max(lengths))]})
    posts = {key: post for key, post in ft.forward_outputs(out)[0]
             if key in wanted}

    def dist(a, b):
        return max(float(abs(a[key] - b[key]).max()) for key in wanted)

    if recipe != "QLSTM":
        cpu = ft.forward_utterances(exp, wanted, "cpu")
        worst = dist(cpu, posts)
        check(worst <= POSTERIOR_ATOL,
              f"CUDA posteriors differ from the CPU path by {worst}")
        if not float64:
            return f"max_abs_err={worst:.3e} (atol {POSTERIOR_ATOL:g})"
        ref = ft.forward_utterances(exp, wanted, "cpu", torch.float64)
        gap64 = dist(ref, ft.forward_utterances(exp, wanted, "cuda",
                                                torch.float64))
        check(gap64 <= F64_PATHS_ATOL,
              f"the card's float64 forward differs from the CPU's by {gap64}")
        return (f"max_abs_err={worst:.3e} (atol {POSTERIOR_ATOL:g}); in "
                f"float64 the card {gap64:.3e} from the CPU (atol "
                f"{F64_PATHS_ATOL:g}); float32 from the CPU's float64: CUDA "
                f"{dist(ref, posts):.3e}, CPU {dist(ref, cpu):.3e}")
    cpu_bf16 = _cpu_posteriors(ft, exp, wanted, "pallas")
    gap = dist(cpu_bf16, _cpu_posteriors(ft, exp, wanted, "scan"))
    worst = dist(cpu_bf16, posts)
    check(worst <= max(POSTERIOR_ATOL, gap),
          f"CUDA posteriors differ from the CPU bf16-U path by {worst} "
          f"(CPU bf16-U vs float32 {gap})")
    return (f"max_abs_err={worst:.3e} vs the bf16-U plain version (atol "
            f"max({POSTERIOR_ATOL:g}, CPU bf16-U vs float32 {gap:.3e}))")


def sinc251_phase(modules, trees) -> dict:
    """SincNet at its published 251-tap layer 0 (cfg/TIMIT/SincNet_raw.cfg
    with `sinc_len_filt = 251,5,5`, SINC251) through run_exp on the card
    over the raw tree: one train chunk at the card's default step graphs,
    its valid chunk, then the forward stage.  K5f once per (train + valid
    + forward) batch and K5b once per train batch, both more than 0, no
    other kernel; the arks finite and two utterances held to the CPU path;
    frames/s from the `.info` files.  Returns K5's launches."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    out = os.path.join(WORK, "sinc251")
    os.makedirs(out)
    cfg = ft.write_train_cfg(trees["RAW"], out, os.path.join(out, "run.cfg"),
                             {**SINC251_CUTS, **SINC251},
                             recipe=ft.recipe_cfg("SincNet"))
    _reset_counts(modules, chunk_runtime)
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts(modules)
    _check_only(counts, "SincNet", "SincNet-251 run")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)
    steps = _graph_counts(chunk_runtime)
    fwd, bwd = counts["conv_pool_fwd"], counts["conv_pool_bwd"]
    check(fwd > 0 and fwd == n_train + n_valid + n_fwd,
          f"SincNet-251: K5f {fwd}, expected {n_train} train + {n_valid} "
          f"valid + {n_fwd} forward batches")
    check(bwd > 0 and bwd == n_train,
          f"SincNet-251: K5b {bwd}, expected {n_train} train batches")
    taps = [a.options.get("sinc_len_filt") for a in exp.archs.values()
            if a.class_name == "SincNet"]
    check(taps == ["251,5,5"], f"SincNet-251 ran sinc_len_filt {taps}")
    infos = {f: chunk_runtime.read_info(p)
             for f, p in _train_infos(out).items()}
    check(len(infos) == 2, f"SincNet-251 train/valid .info: {sorted(infos)}")
    for f, v in infos.items():
        check(math.isfinite(v["loss"]) and math.isfinite(v["err"])
              and v["frames"] > 0, f"SincNet-251 {f}: {v}")
    with open(os.path.join(out, "res.res")) as f:
        ep = [line for line in f.read().splitlines() if line.startswith("ep=")]
    check(len(ep) == 1, f"SincNet-251 res.res: {ep}")
    n_test = TREES["RAW"]["splits"]["test"][0]
    posts, info = ft.forward_outputs(out)
    names, lengths = _check_arks(list(posts), n_test)
    cpu = _check_cpu_path(ft, exp, out, names, lengths, "SincNet")
    print(f"SincNet-251 (cfg/TIMIT/SincNet_raw.cfg, sinc_len_filt = "
          f"251,5,5, 80,60,60 filters, pools 3,3,3; 1 train chunk, its "
          f"valid chunk, the forward stage): {n_train} train + {n_valid} "
          f"valid + {n_fwd} forward batches; conv_pool_fwd launches {fwd} "
          f"(= {n_train + n_valid + n_fwd}), conv_pool_bwd launches {bwd} "
          f"(= {n_train}); steps: captures {steps['graph_captures']}, "
          f"replays {steps['graph_replays']}, eager {steps['eager_steps']}; "
          f"run_experiment wall {wall:.3f} s; {ep[0]}", flush=True)
    for f, v in infos.items():
        print(f"SincNet-251 .info {f}: loss={v['loss']:.4f} "
              f"err={v['err']:.4f} frames={int(v['frames'])} "
              f"{v['frames_per_sec']:.1f} frames/s, phases {_phases(v)}",
              flush=True)
    print(f"SincNet-251 forward stage: {n_test} utterances, "
          f"{int(info['frames'])} frames, {info['frames_per_sec']:.1f} "
          f"frames/s (.info); arks finite, {N_PDFS} wide; CUDA vs CPU path "
          f"(2 utterances) {cpu}", flush=True)
    return {"conv_pool_fwd": fwd, "conv_pool_bwd": bwd}


def _phases(info) -> str:
    return " ".join(f"{k[6:]}={v:.3f}" for k, v in info.items()
                    if k.startswith("phase_"))


def serving_phase(modules, trees, recipe, replace=None, tag=None) -> dict:
    """The serving path of one recipe: production forward from seeded final
    checkpoints.  `replace` changes lines of the cfg on both paths (the
    flagship at 5 x 2048: WIDE_LAYERS), `tag` names such a run."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    r = RECIPES[recipe]
    tree = trees[r["corpus"]]
    dim = TREES[r["corpus"]]["dim"]
    n_test = TREES[r["corpus"]]["splits"]["test"][0]
    replace = replace or {}
    label = tag or recipe
    out = os.path.join(WORK, f"serve_{label}")
    out_plain = os.path.join(WORK, f"serve_{label}_plain")
    for d in (out, out_plain):
        os.makedirs(d)
    src = ft.recipe_cfg(recipe)
    cfg = ft.write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), replace,
                            recipe=src)
    cfg_plain = ft.write_prod_cfg(tree, out_plain,
                                  os.path.join(out_plain, "run.cfg"),
                                  {**replace, **_plain_replace(recipe)},
                                  recipe=src)
    # the same seed, so both runs read the same weights
    ft.save_seeded_finals(cfg, dim=dim)
    ft.save_seeded_finals(cfg_plain, dim=dim)

    _reset_counts(modules, chunk_runtime)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, n_batches = _counts(modules), chunk_runtime.forward_batches
    launches, bwd = counts[r["fwd"]], counts[r["bwd"]]
    stack_launches = _check_only(counts, recipe, f"{recipe} serving")
    posts, info = ft.forward_outputs(out)

    # the plain path at the same forward batch as the kernel path's
    plain_ctx, plain_label = _plain_path(recipe, modules)
    _reset_counts(modules, chunk_runtime)
    t0 = time.perf_counter()
    with plain_ctx:
        run_experiment(cfg_plain, device="cuda")
    wall_plain = time.perf_counter() - t0
    check(not any(_counts(modules).values()),
          f"{label} plain path still launched a kernel: {_counts(modules)}")
    posts_plain, info_plain = ft.forward_outputs(out_plain)

    posts, posts_plain = list(posts), list(posts_plain)
    names, lengths = _check_arks(posts, n_test)
    worst_plain = 0.0
    for (key, post), (key_p, post_p) in zip(posts, posts_plain):
        check(key == key_p, f"ark order differs: {key} vs {key_p}")
        worst_plain = max(worst_plain, float(abs(post - post_p).max()))
    check(worst_plain <= POSTERIOR_ATOL,
          f"{label}: kernel path vs plain path posteriors differ by {worst_plain}")
    # every forward batch ran its layers through the kernel; the test
    # utterances in batches of at most the port's default forward batch
    # take at least n / that many batches
    fwd_bs = int(os.environ.get("TPUKALDI_FORWARD_BATCH",
                                str(chunk_runtime.DEFAULT_FORWARD_BATCH)))
    check(n_batches >= math.ceil(len(names) / fwd_bs),
          f"{n_batches} forward batches for {len(names)} utterances")
    check(launches == r["layers"] * n_batches and bwd == 0,
          f"{r['fwd']} launched {launches} times, {r['bwd']} {bwd}, expected "
          f"{r['layers']} x {n_batches} forward batches and 0")
    frames = int(sum(lengths))
    check(int(info["frames"]) == frames, f".info frames {info['frames']} != {frames}")
    cpu = _check_cpu_path(ft, exp, out, names, lengths, recipe)

    print(f"serving {label}: {n_test} utterances, {frames} frames, {n_batches} "
          f"forward batches of up to {fwd_bs}, {r['fwd']} launches {launches} "
          f"(= {r['layers']} x {n_batches}), {r['bwd']} launches {bwd}, arks "
          f"{N_PDFS} wide, all finite; peak device memory {peak:.2f} GiB",
          flush=True)
    print(f"serving {label} kernel path: forward stage "
          f"{info['elapsed_time_chunk']:.3f} s, {info['frames_per_sec']:.1f} "
          f"frames/s (.info), run_experiment wall {wall:.3f} s, phases "
          f"{_phases(info)}", flush=True)
    print(f"serving {label} plain path ({plain_label}): forward stage "
          f"{info_plain['elapsed_time_chunk']:.3f} s, "
          f"{info_plain['frames_per_sec']:.1f} frames/s (.info), run_experiment "
          f"wall {wall_plain:.3f} s, phases {_phases(info_plain)}", flush=True)
    print(f"serving {label} agreement: kernel vs plain path max_abs_err="
          f"{worst_plain:.3e} (atol {POSTERIOR_ATOL:g}), CUDA vs CPU path (2 "
          f"utterances) {cpu}", flush=True)
    if recipe == "liGRU" and not replace:
        pipeline_depth_check(cfg, info)
    return {"cfg": cfg, "stack_launches": stack_launches, "launches": launches}


def _refused(what, fn, *needles) -> str:
    """fn() must raise a ValueError whose message holds every needle;
    returns the message.  No other exception is caught."""
    try:
        fn()
    except ValueError as e:
        msg = str(e)
        check(all(n in msg for n in needles),
              f"{what}: refused as {msg!r}, which does not name {needles}")
        return msg
    raise AssertionError(f"{what}: ran, where a ValueError was expected")


def wide_phase(modules, trees) -> dict:
    """Serving past the backward kernels' limit: the flagship at
    5 x 2048 (WIDE_LAYERS) through `serving_phase` (K1f once per layer per
    forward batch, K1b never, arks held to the scan path and two utterances
    to the CPU path); then, with every count at 0, the refusals: each
    forward kernel's entry at H = FWD_MAX_HIDDEN + 1 (K4f through both), and
    a train step of the flagship at 5 x 2048, whose Function refuses K1b's
    H <= BWD_MAX_HIDDEN before its forward launches: each a ValueError
    naming the limit, and no kernel launched.  Returns K1f's launches on the
    serving run."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime

    served = serving_phase(modules, trees, "liGRU", WIDE_LAYERS, "liGRU-2048")
    _reset_counts(modules, chunk_runtime)
    T, B, H = 2, 1, FWD_MAX_HIDDEN + 1
    for cell in ("ligru", "lstm", "gru", "lstm_lean"):
        mod = modules["lstm" if cell == "lstm_lean" else cell]
        fns = _cell_fns(cell, mod)
        n_gates = {"ligru": 2, "lstm": 4, "gru": 3, "lstm_lean": 4}[cell]
        ff = torch.zeros(T, B, n_gates * H, device="cuda")
        ws = ((torch.zeros(H, 2 * H, device="cuda"),
               torch.zeros(H, H, device="cuda")) if cell == "gru"
              else (torch.zeros(H, n_gates * H, device="cuda"),))
        mask = torch.ones(B, H, device="cuda")
        entries = [(f"{cell}_fwd", ff)]
        if cell == "lstm_lean":
            entries.append(("lstm_lean_fwd bf16 ff", ff.to(torch.bfloat16)))
        for label, x in entries:
            msg = _refused(f"{label} at H={H}",
                           lambda x=x: fns["fwd"](x, ws, mask), f"H={H}",
                           f"limit of {FWD_MAX_HIDDEN}")
            print(f"refused {label} at H={H}: {msg}", flush=True)
    out = os.path.join(WORK, "train_liGRU-2048")
    os.makedirs(out)
    cfg = ft.write_train_cfg(trees["TIMIT"], out, os.path.join(out, "run.cfg"),
                             {**_cuts("liGRU"), **WIDE_LAYERS},
                             recipe=ft.recipe_cfg("liGRU"))
    msg = _refused("a train step of the flagship at 5 x 2048",
                   lambda: ft.train_step_gradients(cfg, "cuda"),
                   "ligru_recurrence_bwd", f"H={FWD_MAX_HIDDEN}",
                   f"limit of {BWD_MAX_HIDDEN}")
    print(f"refused a train step of the flagship at 5 x {FWD_MAX_HIDDEN}: "
          f"{msg}", flush=True)
    counts = _counts(modules)
    check(not any(counts.values()), f"the refusals launched kernels: {counts}")
    return {"ligru_fwd": served["launches"]}


def _drop_forward_ledger(out) -> None:
    """Remove the forward tasks' ledger and arks, so the stage runs again."""
    ef = os.path.join(out, "exp_files")
    for f in os.listdir(ef):
        if f.startswith("forward_"):
            os.remove(os.path.join(ef, f))


def _forward_arks(out):
    ef = os.path.join(out, "exp_files")
    arks = {}
    for f in sorted(os.listdir(ef)):
        if f.startswith("forward_") and f.endswith(".ark"):
            with open(os.path.join(ef, f), "rb") as fh:
                arks[f] = fh.read()
    return arks


def pipeline_depth_check(cfg, info) -> None:
    """The forward stage again at TPUKALDI_FORWARD_PIPELINE_DEPTH=1 (each
    batch's posteriors on the host before the next batch's): its arks
    byte-equal to the default depth 6's (a read of a copy not yet done, or
    of a pinned buffer reused too early, would change bytes)."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment

    out = os.path.dirname(cfg)
    deep = _forward_arks(out)
    check(bool(deep), f"no forward arks under {out}")
    _drop_forward_ledger(out)
    with _env(TPUKALDI_FORWARD_PIPELINE_DEPTH="1"):
        run_experiment(cfg, device="cuda")
    _, info_1 = ft.forward_outputs(out)
    shallow = _forward_arks(out)
    check(shallow == deep, "arks at forward pipeline depth 1 differ from "
          "depth 6's: " + ", ".join(f for f in deep
                                     if shallow.get(f) != deep[f]))
    print(f"serving liGRU forward pipeline: depth 1 and depth 6 arks "
          f"byte-equal ({len(deep)} arks, {sum(map(len, deep.values()))} "
          f"bytes); forward stage {info_1['elapsed_time_chunk']:.3f} s at "
          f"depth 1, {info['elapsed_time_chunk']:.3f} s at depth 6", flush=True)


def _train_infos(out):
    ef = os.path.join(out, "exp_files")
    return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
            if f.endswith(".info") and f.startswith(("train_", "valid_"))}


def train_phase(modules, trees, recipe) -> dict:
    """The main path of one recipe: full-width training, then forward."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    r = RECIPES[recipe]
    tree = trees[r["corpus"]]
    src = ft.recipe_cfg(recipe)
    out = os.path.join(WORK, f"train_{recipe}")
    out_plain = os.path.join(WORK, f"train_{recipe}_plain")
    for d in (out, out_plain):
        os.makedirs(d)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             _cuts(recipe), recipe=src)
    cfg_plain = ft.write_train_cfg(
        tree, out_plain, os.path.join(out_plain, "run.cfg"),
        {**_cuts(recipe), **_plain_replace(recipe)}, recipe=src)

    # the main path, counted
    _reset_counts(modules, chunk_runtime)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    # the data path of its train and valid chunks (the device cache's
    # default for the card, or the host path and why)
    chunk_paths = (chunk_runtime.cache_chunks, chunk_runtime.host_chunks,
                   chunk_runtime.host_reason)
    counts = _counts(modules)
    launches, bwd = counts[r["fwd"]], counts[r["bwd"]]
    stack_launches = _check_only(counts, recipe, f"{recipe} training")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)
    steps = _graph_counts(chunk_runtime)

    # the ledger: 2 epochs x (2 train chunks + 1 valid chunk)
    infos = _train_infos(out)
    check(len(infos) == 6, f"train/valid .info files: {sorted(infos)}")
    values = {f: chunk_runtime.read_info(p) for f, p in infos.items()}
    for f, v in values.items():
        check(math.isfinite(v["loss"]) and math.isfinite(v["err"])
              and v["frames"] > 0, f"{f}: {v}")
        check(all(f"phase_{k}" in v for k in PIPELINE_PHASES),
              f"{f}: no {PIPELINE_PHASES} among {sorted(v)}")
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
    phase_lines = [line for line in res if line.startswith("phases ep=")]
    check(len(phase_lines) == 2 and all(
        " host_load=" in line and " host_load_producer=" in line
        for line in phase_lines), f"res.res phases lines: {phase_lines}")
    tr_loss = [float(line.split(" loss=")[1].split()[0]) for line in ep_lines]
    check(tr_loss[1] < tr_loss[0], f"{recipe} train loss did not fall: {tr_loss}")

    # the forward kernel ran in every layer of every batch, the backward
    # kernel in every train batch: 2 epochs x 2 chunks x 32 utterances in
    # sentence batches, or the raw recipes' frame batches of 128 windows
    # (each train .info counts its batches' frames)
    layers = r["layers"]
    expected = 2 * 2 * 32 // r["batch"]
    if _raw(recipe):
        # (a chunk smaller than a batch runs as one batch of its frames)
        expected = sum(max(1, int(v["frames"]) // r["batch"])
                       for f, v in values.items() if f.startswith("train_"))
    check(n_train == expected, f"{n_train} train batches, expected {expected}")
    check(launches == layers * (n_train + n_valid + n_fwd),
          f"{r['fwd']} launched {launches} times, expected {layers} x "
          f"({n_train} train + {n_valid} valid + {n_fwd} forward batches)")
    check(bwd == layers * n_train,
          f"{r['bwd']} launched {bwd} times, expected {layers} x {n_train}")

    n_test = TREES[r["corpus"]]["splits"]["test"][0]
    posts, _ = ft.forward_outputs(out)
    names, lengths = _check_arks(list(posts), n_test)
    cpu = _check_cpu_path(ft, exp, out, names, lengths, recipe)

    print(f"training {recipe}: 2 epochs, {n_train} train + {n_valid} valid + "
          f"{n_fwd} forward batches; {r['fwd']} launches {launches} (= "
          f"{layers} x {n_train + n_valid + n_fwd}), {r['bwd']} launches "
          f"{bwd} (= {layers} x {n_train}); train and valid steps at the "
          f"default TPUKALDI_MULTISTEP: captures {steps['graph_captures']}, "
          f"replays {steps['graph_replays']}, eager {steps['eager_steps']}; "
          f"run_experiment wall {wall:.3f} s", flush=True)
    for line in res:
        print(f"training {recipe} res.res: {line}", flush=True)
    for f, v in values.items():
        print(f"training {recipe} .info {f}: loss={v['loss']:.4f} "
              f"err={v['err']:.4f} frames={int(v['frames'])} "
              f"{v['frames_per_sec']:.1f} frames/s, phases {_phases(v)}",
              flush=True)
    for f, v in values.items():
        print(f"training {recipe} .info {f} hand-off: " + " ".join(
            f"{k}={v[f'phase_{k}']:.3f}" for k in PIPELINE_PHASES), flush=True)
    print(f"training {recipe} arks: {n_test} finite, {N_PDFS} wide; CUDA vs "
          f"CPU path (2 utterances) {cpu}", flush=True)

    # the plain path on the first train chunk only
    exp_plain, plan_plain = ft.train_plan(cfg_plain)
    task = plan_plain.epochs[0].tasks[0]
    rt = chunk_runtime.ChunkRuntime(exp_plain, "cuda")
    plain_ctx, plain_label = _plain_path(recipe, modules)
    _reset_counts(modules, chunk_runtime)
    with plain_ctx:
        plain = rt.run_task(
            task, epoch_lr={a: s.lr[0] for a, s in exp_plain.archs.items()},
            batch_size=exp_plain.batches.batch_size_train[0])
        rt.checkpointer.wait()
    check(not any(_counts(modules).values()),
          f"{recipe} plain path launched a kernel: {_counts(modules)}")
    first = values[os.path.basename(task.info_file)]
    draws = ("layer 0's dropout drawn otherwise: one seed for K6's hash mask "
             "against a Bernoulli tensor" if recipe == "CNN"
             else "the same dropout draws")
    print(f"training {recipe} first train chunk: kernel path "
          f"{first['frames_per_sec']:.1f} frames/s, plain path ({plain_label}) "
          f"{plain.frames_per_sec:.1f} frames/s (.info); loss "
          f"{first['loss']:.6f} vs {plain.loss:.6f} ({draws}); phases kernel "
          f"path {_phases(first)}, plain path " + " ".join(
              f"{k}={v:.3f}" for k, v in plain.phases.items()), flush=True)

    step_check(modules, trees, recipe)
    if recipe == "liGRU":
        async_checkpoint_check(trees, recipe)
    return {"launches": launches, "bwd_launches": bwd, "cfg": cfg,
            "stack_launches": stack_launches, "chunk_paths": chunk_paths}


# the multistep phase's trees for the sequence recipes: a train chunk of 128
# utterances and a dev chunk whose lengths fall in one bucket (310-400
# frames: bucket 400), so that a chunk's batches form groups of 8, as the
# length-sorted chunks of a full TIMIT epoch (~740 utterances a chunk) do;
# the raw recipes keep the RAW tree (58-64 frame batches a chunk)
MS_TREES = {
    "TIMIT": dict(dim=40, splits={"train": (128, 310, 400),
                                  "dev": (64, 310, 400), "test": (8, 310, 400)}),
    "DIRHA": dict(dim=40, splits={"train": (128, 310, 400),
                                  "dev": (128, 310, 400), "test": (8, 310, 400)}),
}
# K of the multistep phase's graphed runs (the card's default)
MS_K = 8
# where two K=1 runs differ (a nondeterministic reduction), the K=8 run's
# final weights may be this many times as far from the first K=1 run's
MS_NOISE_FACTOR = 2.0
# the device records a profiler trace may lose of one kernel: on an H100 a
# warm chunk's trace once held 63 of 64 eager K6f launches (about one
# kernel count in twenty).  A trace never holds more launches than were
# made, and a replay that counts wrong is off by a launch a step or more
# (16-80 in a warm chunk)
MS_TRACE_LOST = 1
# K1f captured alone, at the flagship's training shape (B' = 16)
MS_K1F_SHAPE = (400, 16, 550)


def _graph_counts(chunk_runtime):
    return {k: getattr(chunk_runtime, k)
            for k in ("graph_captures", "graph_replays", "eager_steps")}


def _reset_graph_counts(chunk_runtime):
    for k in ("graph_captures", "graph_replays", "eager_steps"):
        setattr(chunk_runtime, k, 0)


def k1f_capture_check(ligru) -> None:
    """K1f alone captured into a CUDA graph (its cooperative launch and the
    scratch zeroing before it) and replayed, held bitwise to the eager
    call."""
    T, B, H = MS_K1F_SHAPE
    ff, ws, mask, _ = _recurrence_inputs("ligru", T, B, H, 7)
    eager = ligru.ligru_recurrence(ff, *ws, mask)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    n0 = ligru.launches
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        out = ligru.ligru_recurrence(ff, *ws, mask)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    ligru.launches = n0
    out.fill_(float("nan"))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(out, eager), "K1f: the graph's replay differs from the "
          f"eager call by {float((out - eager).abs().max())}")
    print(f"multistep K1f alone at {MS_K1F_SHAPE}: captured (cooperative "
          "launch, scratch zeroed in the graph), two replays bitwise equal "
          "to the eager call", flush=True)


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms, benchmarking off, while in place."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _launch_events(counts, per_op):
    """{device kernel: (its launches in a trace's `per_op`, the sum of the
    launch counters that count it)} for each kernel of KERNEL_EVENTS."""
    out = {}
    for kernel, names in KERNEL_EVENTS.items():
        pattern = re.compile(rf"(?<![a-z_]){kernel}(?![a-z_])")
        out[kernel] = (sum(n for op, (n, _) in per_op.items()
                           if pattern.search(op)),
                       sum(counts[name] for name in names))
    return out


def _ms_ledger(run):
    return tuple((run[p].loss, run[p].err) for p in ("train", "valid"))


def _ms_weights(rt):
    return {f"{a}.{k}": v.detach().clone()
            for a, m in rt.graph.modules.items()
            for k, v in m.state_dict().items()}


def _ms_run(modules, cfg, k, warm, mesh=None):
    """One train chunk and one valid chunk of the cfg's first epoch on a
    fresh runtime at TPUKALDI_MULTISTEP=k (under the process group `mesh`
    where given): the two ChunkResults and the
    train chunk's wall, the checkpoints' bytes, the final weights, the
    kernels' launches, the runtime's step counts and the graphs' pool
    bytes; with `warm`, the same train chunk once more on the same runtime
    (its graphs captured) under torch.profiler (device activity only): its
    ChunkResult, wall, device busy seconds, step counts and each hand
    kernel's launches in the trace beside its counters (`_launch_events`)."""
    from torch.profiler import ProfilerActivity, profile

    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime

    exp, plan = ft.train_plan(cfg)
    tasks = plan.epochs[0].tasks
    train = [t for t in tasks if t.phase == "train"][0]
    valid = [t for t in tasks if t.phase == "valid"][0]
    with _env(TPUKALDI_MULTISTEP=str(k)):
        rt = chunk_runtime.ChunkRuntime(exp, "cuda", mesh)
    check(rt.multistep_k == k, f"TPUKALDI_MULTISTEP={k} read as "
          f"{rt.multistep_k}")
    chunks = {t.phase: rt.load_task_chunk(t) for t in (train, valid)}
    _reset_counts(modules, chunk_runtime)
    _reset_graph_counts(chunk_runtime)
    kw = dict(epoch_lr={a: s.lr[0] for a, s in exp.archs.items()},
              chunk=chunks["train"], batch_size=exp.batches.batch_size_train[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_train = rt.run_task(train, **kw)
    torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0,
               train_steps=_graph_counts(chunk_runtime))
    res_valid = rt.run_task(valid, chunk=chunks["valid"],
                            batch_size=exp.batches.batch_size_valid)
    rt.checkpointer.wait()
    ckpts = {}
    for path in train.ckpt_files.values():
        with open(path, "rb") as f:
            ckpts[os.path.basename(path)] = f.read()
    out.update(train=res_train, valid=res_valid, ckpts=ckpts,
               weights=_ms_weights(rt), counts=_counts(modules),
               steps=_graph_counts(chunk_runtime), pool=rt.graph_pool_bytes())
    if warm:
        _reset_counts(modules, chunk_runtime)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # one launch ahead of the chunk, so that the trace is live
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rt.run_task(train, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rt.checkpointer.wait()
        busy_us, per_op = _device_events(prof)
        out["warm"] = dict(train=res, wall=wall, busy=busy_us / 1e6,
                           steps=_graph_counts(chunk_runtime),
                           launches=_launch_events(_counts(modules), per_op),
                           per_op=per_op)
    return out


def multistep_phase(modules, trees, recipe) -> None:
    """TPUKALDI_MULTISTEP on the card: one recipe's train and valid chunk
    from one init at recipe dropout, twice at K = 1 and once at K = 8
    (groups on CUDA graphs).  K = 8 gives the K = 1 ledger and checkpoints
    bitwise where the two K = 1 runs agree bitwise, else final weights no
    further from the first K = 1 run than MS_NOISE_FACTOR times the second
    K = 1 run is; the same launches of every kernel; its train steps run as
    replays.  The second K = 1 run and the K = 8 run then train the same
    chunk once more, warm (the K = 8 runtime's graphs captured), under the
    profiler for the idle share; each hand kernel's launches in that trace
    must equal its counters (short by MS_TRACE_LOST at most), so that the
    counts a replay adds are measured.
    A raw recipe's K = 1 runs differ (cuDNN's weight gradients of layers
    1-3), so `multistep_deterministic` holds it bitwise once more."""
    from tpukaldi_torch.tools import flagship_tree as ft

    r = RECIPES[recipe]
    src = ft.recipe_cfg(recipe)
    tree = trees["RAW"] if _raw(recipe) else trees[f"MS_{r['corpus']}"]
    cuts = (_cuts(recipe) if _raw(recipe) else
            {**_cuts(recipe), "n_chunks = 5": "n_chunks = 1"})
    runs = {}
    for name, k, warm in (("K1a", 1, False), ("K1b", 1, True),
                          (f"K{MS_K}", MS_K, True)):
        out = os.path.join(WORK, f"multistep_{recipe}_{name}")
        os.makedirs(out)
        cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                                 cuts, recipe=src)
        runs[name] = _ms_run(modules, cfg, k, warm)
    a, b, g = runs["K1a"], runs["K1b"], runs[f"K{MS_K}"]

    def wdiff(x, y):
        return max(float((x["weights"][n].double()
                          - y["weights"][n].double()).abs().max())
                   for n in x["weights"])

    def phases(res):
        return " ".join(f"{k}={v:.3f}" for k, v in res.phases.items())

    yard, diff = wdiff(b, a), wdiff(g, a)
    repeat_bitwise = b["ckpts"] == a["ckpts"]
    bitwise = g["ckpts"] == a["ckpts"]
    for name, run in runs.items():
        res = run["train"]
        print(f"multistep {recipe} {name}: train loss={res.loss} "
              f"err={res.err}, valid loss={run['valid'].loss} "
              f"err={run['valid'].err} (.info); steps {res.n_batches} train "
              f"+ {run['valid'].n_batches} valid: captures "
              f"{run['steps']['graph_captures']}, replays "
              f"{run['steps']['graph_replays']}, eager "
              f"{run['steps']['eager_steps']}; graph pool {run['pool']} "
              f"bytes; first train chunk {res.frames_per_sec:.1f} frames/s "
              f"(.info), wall {run['wall']:.3f} s, phases {phases(res)}",
              flush=True)
    for name in ("K1b", f"K{MS_K}"):
        w = runs[name]["warm"]
        res = w["train"]
        launched = {k: v for k, v in w["launches"].items() if v != (0, 0)}
        print(f"multistep {recipe} {name} warm train chunk: launches in the "
              "trace / counted: " + ", ".join(
                  f"{k} {e}/{c}" for k, (e, c) in launched.items()),
              flush=True)
        check(all(c - MS_TRACE_LOST <= e <= c
                  for e, c in w["launches"].values()),
              f"{recipe} {name}: the trace's launches differ from the "
              f"counters by more than {MS_TRACE_LOST} lost records: "
              f"{launched}")
        check(all(any(r[kind] in KERNEL_EVENTS[k] for k in launched)
                  for kind in ("fwd", "bwd")),
              f"{recipe} {name}: {r['fwd']} or {r['bwd']} not in the trace: "
              f"{launched}")
        print(f"multistep {recipe} {name} warm train chunk: {res.n_batches} "
              f"steps (captures {w['steps']['graph_captures']}, replays "
              f"{w['steps']['graph_replays']}, eager "
              f"{w['steps']['eager_steps']}), {res.frames} frames, "
              f"{res.frames_per_sec:.1f} frames/s (.info), wall "
              f"{w['wall']:.3f} s, device busy {w['busy']:.3f} s, idle share "
              f"{1 - w['busy'] / w['wall']:.3f}, phases {phases(res)}",
              flush=True)
    print(f"multistep {recipe}: checkpoints K{MS_K} vs K1a bitwise "
          f"{bitwise}, K1b vs K1a bitwise {repeat_bitwise}; final weights "
          f"max|K{MS_K} - K1a| {diff:.3e}, max|K1b - K1a| {yard:.3e}; "
          f"launches {g['counts'][r['fwd']]} {r['fwd']}, "
          f"{g['counts'][r['bwd']]} {r['bwd']} at K{MS_K}, "
          f"{a['counts'][r['fwd']]}, {a['counts'][r['bwd']]} at K1", flush=True)
    check(g["counts"] == a["counts"] == b["counts"],
          f"{recipe}: launches at K{MS_K} {g['counts']}, at K1 {a['counts']}")
    check(a["steps"]["graph_captures"] == 0 == b["steps"]["graph_captures"],
          f"{recipe}: K1 captured a step graph")
    for what, steps, n in (
            ("first", g["train_steps"], g["train"].n_batches),
            ("warm", g["warm"]["steps"], g["warm"]["train"].n_batches)):
        check(steps["graph_replays"] >= n // 2,
              f"{recipe}: K{MS_K}'s {what} train chunk ran {steps} of {n} "
              "steps")
    check(g["train_steps"]["graph_captures"] >= 1
          and g["warm"]["steps"]["graph_captures"] == 0,
          f"{recipe}: captures {g['train_steps']}, then {g['warm']['steps']}")
    if repeat_bitwise:
        check(bitwise and _ms_ledger(g) == _ms_ledger(a),
              f"{recipe}: K{MS_K} differs from K1 where two K1 runs agree "
              f"bitwise (weights {diff:.3e})")
    else:
        check(diff <= MS_NOISE_FACTOR * yard,
              f"{recipe}: K{MS_K} {diff:.3e} from K1a, two K1 runs {yard:.3e}")
    if _raw(recipe):
        multistep_deterministic(modules, tree, cuts, src, recipe)


def multistep_deterministic(modules, tree, cuts, src, recipe) -> None:
    """A raw recipe's train and valid chunk under deterministic cuDNN, from
    one init at recipe dropout: two K = 1 runs, which must agree bitwise,
    and a K = 8 run, whose train steps replay CUDA graphs (K5 or K6, the
    dropout masks and K6's seed drawn from the registered generator), which
    must give their `.info` loss and err and checkpoints bitwise."""
    from tpukaldi_torch.tools import flagship_tree as ft

    runs = {}
    with _deterministic_cudnn():
        for name, k in (("K1a", 1), ("K1b", 1), (f"K{MS_K}", MS_K)):
            out = os.path.join(WORK, f"multistep_{recipe}_det_{name}")
            os.makedirs(out)
            cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                                     cuts, recipe=src)
            runs[name] = _ms_run(modules, cfg, k, False)
    a, b, g = runs["K1a"], runs["K1b"], runs[f"K{MS_K}"]
    for name, run in runs.items():
        print(f"multistep {recipe} deterministic cuDNN {name}: train loss="
              f"{run['train'].loss} err={run['train'].err}, valid loss="
              f"{run['valid'].loss} err={run['valid'].err} (.info); train "
              f"steps: captures {run['train_steps']['graph_captures']}, "
              f"replays {run['train_steps']['graph_replays']}, eager "
              f"{run['train_steps']['eager_steps']}", flush=True)
    repeat = b["ckpts"] == a["ckpts"] and _ms_ledger(b) == _ms_ledger(a)
    same = g["ckpts"] == a["ckpts"] and _ms_ledger(g) == _ms_ledger(a)
    print(f"multistep {recipe} deterministic cuDNN: K1b vs K1a bitwise "
          f"{repeat}, K{MS_K} vs K1a bitwise {same} (.info and checkpoints)",
          flush=True)
    check(repeat, f"{recipe}: two K1 runs differ under deterministic cuDNN")
    check(same, f"{recipe}: K{MS_K} differs from K1 under deterministic cuDNN")
    check(g["counts"] == a["counts"], f"{recipe}: launches at K{MS_K} "
          f"{g['counts']}, at K1 {a['counts']}")
    n = g["train"].n_batches
    check(g["train_steps"]["graph_replays"] >= n // 2,
          f"{recipe}: K{MS_K} ran {g['train_steps']} of {n} train steps")


def multistep_all(modules, trees) -> None:
    """K1f captured alone, then each recipe's multistep check; returns the
    trees with the multistep phase's own (MS_TREES) beside them."""
    from tpukaldi_torch.tools import flagship_tree as ft

    k1f_capture_check(modules["ligru"])
    trees = {**trees, **{f"MS_{corpus}": ft.write_kaldi_tree(
        os.path.join(WORK, f"ms_{corpus.lower()}"), dim=t["dim"],
        n_phones=N_PHONES, n_pdfs=N_PDFS, splits=t["splits"], corpus=corpus)
        for corpus, t in MS_TREES.items()}}
    for recipe in RECIPES:
        _timed(f"{recipe} multistep", multistep_phase, modules, trees, recipe)
    return trees


# the bf16 phase: the bf16 compute mode (`[exp] compute_dtype = bfloat16`,
# TPUKALDI_COMPUTE_DTYPE), on the flagship's own bf16 recipe and on the QLSTM
BF16_RECIPE = os.path.join(REPO, "cfg", "TIMIT", "liGRU_fmllr_bf16.cfg")
# one train chunk, its valid chunk and the forward stage
BF16_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1", "n_chunks = 5": "n_chunks = 1"}
# utterances of the bf16 and float32 forwards held to each other, and their
# bound in probability space (tpukaldi's tests/test_bf16.py)
BF16_FWD_UTTS = 8
BF16_POSTERIOR_ATOL = 0.05
# the launch counters of K4's bf16 entries
BF16_COUNTERS = {"lstm_lean_fwd": "lean_bf16_launches",
                 "lstm_lean_bwd": "lean_bf16_bwd_launches"}
# float32 words each call of K4's bf16 entries reads and writes once, as
# WORDS counts them: ff (and K4b's dff) in bf16 count half
BF16_WORDS = {"lstm_lean_fwd": (4, 4, 1), "lstm_lean_bwd": (7, 8, 2)}


def _f32_run():
    """TPUKALDI_COMPUTE_DTYPE=float32 for the runs inside (over a cfg's
    `compute_dtype`)."""
    return _env(TPUKALDI_COMPUTE_DTYPE="float32")


def _bf16_fn_check(name, cell, fns, ins, grad) -> dict:
    """A boundary-cast Function (K1-K3) on bf16 inputs against the float32
    entry on the widened inputs: h bitwise, each gradient bitwise the
    float32 one rounded to bf16.  Returns the casts' device ms."""
    b16 = [t.to(torch.bfloat16) for t in ins]

    def run(dtype):
        leaves = [t.to(dtype).detach().requires_grad_() for t in b16]
        h = fns["fn"](*leaves)
        h.backward(grad)
        return h.detach(), [t.grad for t in leaves]

    h16, g16 = run(torch.bfloat16)
    h32, g32 = run(torch.float32)
    check(h16.dtype == torch.float32 and torch.equal(h16, h32),
          f"{name}: bf16 inputs give h {h16.dtype} differing from the "
          f"float32 entry by {float((h16 - h32).abs().max())}")
    for what, a, b in zip(fns["grads"], g16, g32):
        check(a.dtype == torch.bfloat16 and torch.equal(a, b.to(a.dtype)),
              f"{name}: bf16 {what} is not the float32 entry's rounded")
    fwd = queued_ms(lambda: [t.float() for t in b16])
    bwd = queued_ms(lambda: ([t.float() for t in b16],
                             [g.to(torch.bfloat16) for g in g32]))
    return {"fwd": fwd, "bwd": bwd}


def bf16_kernel_checks(modules) -> dict:
    """Each kernel's bf16 entry at the recipe shapes: K1-K3's Functions and
    K5's and K6's entries widen at their boundary, bitwise the float32
    entry on the widened inputs (outputs and gradients rounded to the
    primal dtype); K4f's bf16-ff entry bitwise the float32 entry on
    ff.float(), K4b's bf16 dff bitwise the float32 dff rounded, its dmask
    bitwise, its dU within DU_RTOL of max|dU| from a float64 h_prev^T
    float(dff).  Returns {kernel: its casts' device ms}, and K4's bf16
    entries' ms beside the float32 entries' with their bounds."""
    conv1d, lstm = modules["conv1d"], modules["lstm"]
    out = {}
    T, B, H = BWD_SHAPES[0]
    for cell in ("ligru", "lstm", "gru"):
        ff, ws, mask, grad = _recurrence_inputs(cell, T, B, H, 21)
        fns = _cell_fns(cell, modules[cell])
        ms = _bf16_fn_check(cell, cell, fns, (ff, *ws, mask), grad)
        out[f"{cell}_fwd"], out[f"{cell}_bwd"] = ms["fwd"], ms["bwd"]
        print(f"bf16 {cell} Function at {(T, B, H)}: h and gradients bitwise "
              f"the float32 entry's on the widened inputs; boundary casts "
              f"{ms['fwd']:.3f} ms forward, {ms['bwd']:.3f} ms backward "
              "(device)", flush=True)
    # K4 at the QLSTM's training shape
    T, B, H = LEAN_BWD_SHAPES[0]
    ff, (u,), mask, grad = _recurrence_inputs("lstm_lean", T, B, H, 22)
    ff16 = ff.to(torch.bfloat16)
    ffw = ff16.float()
    del ff
    h, c = lstm.lstm_recurrence_lean(ff16, u, mask)
    h32, c32 = lstm.lstm_recurrence_lean(ffw, u, mask)
    check(torch.equal(h, h32) and torch.equal(c, c32),
          "K4f: the bf16-ff entry differs from the float32 entry on ff.float()")
    dff, du, dmask = lstm.lstm_recurrence_lean_bwd(ff16, h, c, grad, u, mask)
    dff32, _, dmask32 = lstm.lstm_recurrence_lean_bwd(ffw, h, c, grad, u, mask)
    check(dff.dtype == torch.bfloat16 and torch.equal(dff, dff32.to(dff.dtype))
          and torch.equal(dmask, dmask32),
          "K4b: the bf16 entry's dff is not the float32 dff rounded, or its "
          "dmask differs")
    ref = (h[:-1].reshape(-1, H).double().t()
           @ dff[1:].reshape(-1, 4 * H).double())
    du_err = float((du.double() - ref).abs().max() / ref.abs().max())
    check(du_err <= DU_RTOL, f"K4b: bf16 dU {du_err:.3e} of max|dU| from "
          "h_prev^T float(dff)")
    del dff32, ref
    timing = {}
    for name, fn16, fn32 in (
            ("lstm_lean_fwd", lambda: lstm.lstm_recurrence_lean(ff16, u, mask),
             lambda: lstm.lstm_recurrence_lean(ffw, u, mask)),
            ("lstm_lean_bwd",
             lambda: lstm.lstm_recurrence_lean_bwd(ff16, h, c, grad, u, mask),
             lambda: lstm.lstm_recurrence_lean_bwd(ffw, h, c, grad, u, mask))):
        ms16, ms32 = median_ms(fn16, 3), median_ms(fn32, 3)
        bound = bound_ms(name, T, B, H, BF16_WORDS[name])
        timing[name] = dict(ms=ms16, f32_ms=ms32, bound_ms=bound[0],
                            bound_by=bound[1])
        print(f"bf16 {name} at {(T, B, H)}: bf16-ff entry {ms16:.3f} ms, "
              f"float32 entry {ms32:.3f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]})", flush=True)
    print(f"bf16 K4 at {(T, B, H)}: h and c bitwise the float32 entry's on "
          f"ff.float(), dff bitwise its dff rounded, dmask bitwise, dU "
          f"{du_err:.3e} of max|dU| from float64 h_prev^T float(dff)",
          flush=True)
    del ff16, ffw, h, c, h32, c32, dff, du, grad
    # K5 and K6 at the raw recipes' training batch (K6 with its dropout)
    N, L, K, pool = CONV_TRAIN
    for name, O in (("conv_pool", 80), ("conv_ln", 128)):
        x, w, bias, gt, bt, _ = _conv_inputs(N, L, K, O, pool, 23)
        b16 = [t.to(torch.bfloat16)
               for t in ((x, w) if name == "conv_pool" else (x, w, bias, gt, bt))]

        def run(dtype, name=name, b16=b16):
            leaves = [t.to(dtype).detach().requires_grad_() for t in b16]
            if name == "conv_pool":
                y = conv1d.conv_pool(*leaves, pool)
            else:
                y = conv1d.conv_pool_ln_act(*leaves, 7, pool, 1e-6, True,
                                            CONV_DROP)
            # the same (bf16) incoming gradient for both entries
            gy = torch.linspace(-1, 1, y.numel(), device=y.device)
            y.backward(gy.reshape(y.shape).to(torch.bfloat16).to(y.dtype))
            return y.detach(), [t.grad for t in leaves]

        y16, g16 = run(torch.bfloat16)
        y32, g32 = run(torch.float32)
        check(y16.dtype == torch.bfloat16 and torch.equal(
            y16, y32.to(torch.bfloat16)) and all(
            a.dtype == torch.bfloat16 and torch.equal(a, b.to(a.dtype))
            for a, b in zip(g16, g32)),
            f"{name}: the bf16 entry is not the float32 entry's rounded")
        out[f"{name}_fwd"] = queued_ms(lambda: ([t.float() for t in b16],
                                                y32.to(torch.bfloat16)))
        out[f"{name}_bwd"] = queued_ms(lambda: (
            y16.float(), [g.to(torch.bfloat16) for g in g32]))
        print(f"bf16 {name} at {(N, L, K, O, pool)}: output and gradients "
              f"bitwise the float32 entry's rounded; boundary casts "
              f"{out[f'{name}_fwd']:.3f} ms forward, {out[f'{name}_bwd']:.3f} "
              "ms backward (device)", flush=True)
    return {"casts": out, "lean": timing}


def _final_dtypes(cfg) -> set:
    """The dtypes of every floating leaf of a run's final checkpoints."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.checkpoint import read_checkpoint

    _, plan = ft.train_plan(cfg)
    found = set()

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif getattr(v, "dtype", None) is not None and v.dtype.kind == "f":
                found.add(str(v.dtype))

    for path in plan.final_ckpts.values():
        for tree in read_checkpoint(path):
            walk(tree)
    return found


def _bf16_run(modules, tree, src, out, recipe, replace=None):
    """One train chunk, its valid chunk and the forward stage of `src`
    through `run_experiment` on the card, counted: (cfg, the kernels'
    launches, K4's bf16 launches, the runtime's batch counters, the train
    and forward .info)."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    os.makedirs(out)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             {**_cuts(recipe), **BF16_CUTS, **(replace or {})},
                             recipe=src)
    _reset_counts(modules, chunk_runtime)
    for counter in BF16_COUNTERS.values():
        setattr(modules["lstm"], counter, 0)
    run_experiment(cfg, device="cuda")
    batches = (chunk_runtime.train_batches, chunk_runtime.valid_batches,
               chunk_runtime.forward_batches)
    infos = _train_infos(out)
    train = chunk_runtime.read_info(next(p for f, p in infos.items()
                                         if f.startswith("train_")))
    _, fwd = ft.forward_outputs(out)
    bf16 = {k: getattr(modules["lstm"], c) for k, c in BF16_COUNTERS.items()}
    return cfg, _counts(modules), bf16, batches, train, fwd


def bf16_recipe_phase(modules, trees, recipe) -> dict:
    """A recipe's bf16 compute mode through `run_experiment`: one train
    chunk, its valid chunk and the forward stage in bf16 and, for the
    frames/s beside it, in float32.  The recipe's kernels launch once per
    layer per batch (K4's through its bf16 entries); the final checkpoints
    hold float32 masters; the posteriors are finite.  The flagship runs its
    own bf16 recipe, the QLSTM its recipe under
    TPUKALDI_COMPUTE_DTYPE=bfloat16."""
    from tpukaldi_torch.tools import flagship_tree as ft

    r = RECIPES[recipe]
    tree = trees[r["corpus"]]
    src = BF16_RECIPE if recipe == "liGRU" else ft.recipe_cfg(recipe)
    def env():
        return (contextlib.nullcontext() if recipe == "liGRU"
                else _env(TPUKALDI_COMPUTE_DTYPE="bfloat16"))

    with env():
        cfg, counts, bf16, (n_tr, n_va, n_fw), tr, fw = _bf16_run(
            modules, tree, src, os.path.join(WORK, f"bf16_{recipe}"), recipe)
    # for the frames/s: float32, then bf16 again, both on kernels this
    # process has run before (the first bf16 run loads its own)
    with _f32_run():
        *_, tr32, fw32 = _bf16_run(
            modules, tree, src, os.path.join(WORK, f"bf16_{recipe}_f32"),
            recipe)
    with env():
        *_, tr2, fw2 = _bf16_run(
            modules, tree, src, os.path.join(WORK, f"bf16_{recipe}_again"),
            recipe)
    layers = r["layers"]
    fwd, bwd = counts[r["fwd"]], counts[r["bwd"]]
    check(fwd == layers * (n_tr + n_va + n_fw) and bwd == layers * n_tr > 0,
          f"bf16 {recipe}: {r['fwd']} {fwd}, {r['bwd']} {bwd} launches for "
          f"{n_tr} train + {n_va} valid + {n_fw} forward batches")
    _check_only(counts, recipe, f"bf16 {recipe}")
    if recipe == "QLSTM":
        check(bf16 == {r["fwd"]: fwd, r["bwd"]: bwd},
              f"bf16 QLSTM: K4's bf16 entries launched {bf16} of "
              f"{fwd}, {bwd}")
    dtypes = _final_dtypes(cfg)
    check(dtypes == {"float32"}, f"bf16 {recipe}: final checkpoints hold "
          f"{dtypes}")
    posts, _ = ft.forward_outputs(os.path.join(WORK, f"bf16_{recipe}"))
    n_test = TREES[r["corpus"]]["splits"]["test"][0]
    _check_arks(list(posts), n_test)
    print(f"bf16 {recipe}: one train chunk ({n_tr} batches), {n_va} valid, "
          f"{n_fw} forward batches; {r['fwd']} {fwd}, {r['bwd']} {bwd} "
          f"launches" + (f" (K4's bf16 entries {bf16[r['fwd']]}, "
                         f"{bf16[r['bwd']]})" if recipe == "QLSTM" else "")
          + f"; final checkpoints {sorted(dtypes)}; train loss "
          f"{tr['loss']:.4f} (float32 {tr32['loss']:.4f})", flush=True)
    print(f"bf16 {recipe} frames/s (.info; {_card()}): train bf16 "
          f"{tr2['frames_per_sec']:.1f} (first bf16 run "
          f"{tr['frames_per_sec']:.1f}), float32 "
          f"{tr32['frames_per_sec']:.1f}; forward bf16 "
          f"{fw2['frames_per_sec']:.1f} (first {fw['frames_per_sec']:.1f}), "
          f"float32 {fw32['frames_per_sec']:.1f}", flush=True)
    return {"cfg": cfg, "launches": (fwd, bwd), "bf16_launches": bf16}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bf16_posterior_check(trees) -> None:
    """The flagship's bf16 recipe in production from seeded final weights:
    its bf16 posteriors of BF16_FWD_UTTS utterances within
    BF16_POSTERIOR_ATOL (probability space) of the float32 ones."""
    from tpukaldi_torch.forward.counts import resolve_count_files
    from tpukaldi_torch.tools import flagship_tree as ft

    out = os.path.join(WORK, "bf16_serve")
    os.makedirs(out)
    cfg = ft.write_prod_cfg(trees["TIMIT"], out, os.path.join(out, "run.cfg"),
                            recipe=BF16_RECIPE)
    ft.save_seeded_finals(cfg, dim=TREES["TIMIT"]["dim"])
    test = os.path.join(trees["TIMIT"], "data", "test", "feats.scp")
    with open(test) as f:
        names = [line.split()[0] for line in f][:BF16_FWD_UTTS]
    posts = {}
    for dtype, ctx in (("bf16", contextlib.nullcontext()),
                       ("float32", _f32_run())):
        with ctx:
            exp, _ = ft.train_plan(cfg)
            resolve_count_files(exp, os.path.join(out, "exp_files"))
            posts[dtype] = ft.forward_utterances(exp, names, "cuda")
    b16, f32 = posts["bf16"], posts["float32"]
    gap = max(float(np.abs(np.exp(b16[n]) - np.exp(f32[n])).max())
              for n in names)
    check(all(np.isfinite(b16[n]).all() for n in names),
          "bf16 posteriors not finite")
    print(f"bf16 liGRU serving from seeded finals: {len(names)} utterances, "
          f"bf16 vs float32 posteriors max |p| gap {gap:.3e} (bound "
          f"{BF16_POSTERIOR_ATOL})", flush=True)
    check(gap <= BF16_POSTERIOR_ATOL, f"bf16 posteriors {gap} from float32's")


def bf16_step_check(modules, trees) -> None:
    """One full-width train step of the flagship's bf16 recipe at drop 0:
    the kernel path's master gradients and the scan's (bf16 plain loop),
    both held to a float64 step (float32 compute dtype); the kernel path's
    worst error at most STEP_GRAD_FACTOR times the scan's."""
    from tpukaldi_torch.tools import flagship_tree as ft

    out = os.path.join(WORK, "bf16_step")
    os.makedirs(out)
    cuts = {**_cuts("liGRU"), **_no_drop("liGRU")}
    cfg_k = ft.write_train_cfg(trees["TIMIT"], out, os.path.join(out, "k.cfg"),
                               cuts, recipe=BF16_RECIPE)
    cfg_s = ft.write_train_cfg(trees["TIMIT"], out, os.path.join(out, "s.cfg"),
                               {**cuts, **_scan("liGRU")}, recipe=BF16_RECIPE)
    loss_k, grads_k, shape = ft.train_step_gradients(cfg_k, "cuda")
    loss_s, grads_s, _ = ft.train_step_gradients(cfg_s, "cuda")
    with _f32_run():
        loss_r, grads_r, _ = ft.train_step_gradients(cfg_s, "cuda",
                                                     torch.float64)
    check(all(g.dtype == torch.float32 for g in grads_k.values()),
          "bf16 step: master gradients not float32")

    def worst(grads):
        rel = {n: float((g.double() - grads_r[n]).abs().max()
                        / grads_r[n].abs().max().clamp_min(1e-30))
               for n, g in grads.items()}
        name = max(rel, key=rel.get)
        return rel[name], name

    err_k, name_k = worst(grads_k)
    err_s, name_s = worst(grads_s)
    print(f"bf16 liGRU step at drop 0 (batch {shape}): loss kernel path "
          f"{loss_k:.7f}, scan {loss_s:.7f}, float64 {loss_r:.7f}; worst "
          f"gradient error vs float64: kernel path {err_k:.3e} ({name_k}), "
          f"scan {err_s:.3e} ({name_s}) (factor {STEP_GRAD_FACTOR:g})",
          flush=True)
    check(err_k <= STEP_GRAD_FACTOR * err_s,
          f"bf16 kernel path gradients {err_k} from float64, scan {err_s}")


def bf16_multistep_check(modules, trees) -> None:
    """The flagship's bf16 recipe's train and valid chunk at
    TPUKALDI_MULTISTEP=8 (groups on CUDA graphs of the bf16 step) bitwise
    the K = 1 run's: ledger and checkpoints, and the same launches.  The
    K = 8 run, and one in float32 beside it, train the chunk once more,
    warm, under the profiler: frames/s, idle share, device time by
    layer."""
    from tpukaldi_torch.tools import flagship_tree as ft

    cuts = {**_cuts("liGRU"), "n_chunks = 5": "n_chunks = 1"}
    runs = {}
    for name, k, ctx in (("K1", 1, contextlib.nullcontext()),
                         (f"K{MS_K}", MS_K, contextlib.nullcontext()),
                         (f"K{MS_K} float32", MS_K, _f32_run())):
        out = os.path.join(WORK, f"bf16_multistep_{name.replace(' ', '_')}")
        os.makedirs(out)
        cfg = ft.write_train_cfg(trees["MS_TIMIT"], out,
                                 os.path.join(out, "run.cfg"), cuts,
                                 recipe=BF16_RECIPE)
        with ctx:
            runs[name] = _ms_run(modules, cfg, k, k == MS_K)
    a, g = runs["K1"], runs[f"K{MS_K}"]
    for name in (f"K{MS_K}", f"K{MS_K} float32"):
        w = runs[name]["warm"]
        label = f"bf16 liGRU warm train chunk {name}"
        busy_us = w["busy"] * 1e6
        _print_profile(label, w["wall"], busy_us, w["per_op"], n_top=4)
        print(f"profile {label}: {w['train'].n_batches} steps (replays "
              f"{w['steps']['graph_replays']}, eager "
              f"{w['steps']['eager_steps']}), "
              f"{w['train'].frames_per_sec:.1f} frames/s (.info), phases "
              + " ".join(f"{k}={v:.3f}" for k, v in
                         w["train"].phases.items()), flush=True)
        for layer, us in sorted(_by_layer(w["per_op"]).items(),
                                key=lambda kv: -kv[1]):
            print(f"profile {label} layer: {layer}: {us / 1e3:.1f} ms "
                  f"({us / busy_us:.1%} of busy)", flush=True)
    print(f"bf16 liGRU multistep: K1 train loss {a['train'].loss} err "
          f"{a['train'].err}, K{MS_K} {g['train'].loss} {g['train'].err}; "
          f"K{MS_K} steps: captures {g['steps']['graph_captures']}, replays "
          f"{g['steps']['graph_replays']}, eager {g['steps']['eager_steps']}",
          flush=True)
    check(g["ckpts"] == a["ckpts"] and _ms_ledger(g) == _ms_ledger(a)
          and g["counts"] == a["counts"],
          f"bf16 liGRU: K{MS_K} differs from K1")
    check(g["train_steps"]["graph_replays"] >= g["train"].n_batches // 2,
          f"bf16 liGRU: K{MS_K} ran {g['train_steps']} of "
          f"{g['train'].n_batches} steps as replays")


def _bf16_extra(name, bf16) -> dict:
    """A kernel's bf16 record on the kernels line: its launches in the bf16
    phase's counted runs (K1 in the flagship's bf16 recipe, K4's bf16
    entries in the QLSTM's bf16 chunk), K4's bf16 entry's ms and bound at
    the recipe shape, and the boundary casts' device ms of the others."""
    runs = bf16["runs"]
    out = {}
    if name in ("ligru_fwd", "ligru_bwd"):
        out["bf16_launches"] = runs["liGRU"]["launches"][name == "ligru_bwd"]
    if name in BF16_COUNTERS:
        lean = bf16["lean"][name]
        out.update(bf16_launches=runs["QLSTM"]["bf16_launches"][name],
                   bf16_ms=lean["ms"], bf16_bound_ms=lean["bound_ms"],
                   bf16_bound_by=lean["bound_by"])
    elif name in bf16["casts"]:
        out["bf16_cast_ms"] = bf16["casts"][name]
    return out


def bf16_phase(modules, trees) -> dict:
    """The bf16 compute mode on the card (after the multistep phase)."""
    kern = _timed("bf16 kernel entries", bf16_kernel_checks, modules)
    runs = {recipe: _timed(f"bf16 {recipe}", bf16_recipe_phase, modules,
                           trees, recipe) for recipe in ("liGRU", "QLSTM")}
    _timed("bf16 serving", bf16_posterior_check, trees)
    _timed("bf16 step", bf16_step_check, modules, trees)
    _timed("bf16 multistep", bf16_multistep_check, modules, trees)
    return {**kern, "runs": runs}


def zoo_graph_check(rt, batch, feats, labs, cls) -> None:
    """One train step of a zoo class captured (`make_train_multistep`) and
    replayed against an eager step from the same state and generator seed,
    under deterministic cuDNN: the same loss, and bitwise the same
    parameters, buffers and optimizer state after the two (the update
    too, not only the forward); each one's time between two CUDA events."""
    from tpukaldi_torch.train.step import make_train_multistep, train_step

    state = {f"{a}.{n}": t for a, m in rt.graph.modules.items()
             for n, t in [*m.named_parameters(), *m.named_buffers()]}
    state.update({f"{a}.opt.{i}.{k}": v for a, o in rt.optimizers.items()
                  if o.opt is not None
                  for i, st in enumerate(o.opt.state.values())
                  for k, v in st.items() if isinstance(v, torch.Tensor)})

    def snapshot():
        return {n: t.detach().clone() for n, t in state.items()}

    saved = snapshot()

    def restore():
        with torch.no_grad():
            for n, t in state.items():
                t.copy_(saved[n])

    def timed(fn):
        rt.generator.manual_seed(ZOO_GRAPH_SEED)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = fn()
        end.record()
        torch.cuda.synchronize()
        return loss.item(), start.elapsed_time(end)

    with _deterministic_cudnn():
        loss_e, eager_ms = timed(lambda: train_step(
            rt.graph, rt.optimizers, feats, labs, batch.n_valid_t,
            rt.generator)[0])
        after_e = snapshot()
        restore()
        sg = make_train_multistep(rt.graph, rt.optimizers, feats, labs, True,
                                  rt.device, rt.generator,
                                  torch.cuda.graph_pool_handle())
        sg.load(feats, labs, batch.n_valid_t)
        t0 = time.perf_counter()
        sg.capture(torch.cuda.Stream())
        capture_s = time.perf_counter() - t0
        loss_g, graph_ms = timed(lambda: sg.replay()[0])
        after_g = snapshot()
    check(loss_g == loss_e, f"{cls}: the graphed step's loss {loss_g} "
          f"differs from the eager step's {loss_e}")
    moved = sum(not torch.equal(after_e[n], saved[n]) for n in state)
    differ = {n: float((after_g[n].double() - after_e[n].double()).abs().max())
              for n in state if not torch.equal(after_g[n], after_e[n])}
    check(moved > 0, f"{cls}: the eager step changed no state")
    check(not differ, f"{cls}: the graphed step's state differs from the "
          f"eager step's: {differ}")
    print(f"zoo {cls} graphed step: replay {graph_ms:.2f} ms against the eager "
          f"step's {eager_ms:.2f} ms ({eager_ms / graph_ms:.1f}x), loss "
          f"{loss_g:.7f} both, {len(state)} parameters, buffers and "
          f"optimizer tensors bitwise equal after the two ({moved} moved by "
          f"the step); capture {capture_s:.2f} s", flush=True)


def _host_twin(exp, chunk):
    """A CPU graph of the cfg and its optimizers, to hold a copy of a
    runtime's state (built ahead, so that taking the copy is quick)."""
    from tpukaldi_torch.graph.compiler import build_graph
    from tpukaldi_torch.train.optimizers import make_all_optimizers

    graph = build_graph(exp, chunk.fea_layout, chunk.lab_layout, "cpu")
    return graph.modules, make_all_optimizers(graph.archs, graph.modules)


def _copy_to_host(rt, modules, opts) -> None:
    """The runtime's weights, statistics, optimizer moments, count and lr
    into its CPU twin, stream-ordered after the steps enqueued so far."""
    with torch.no_grad():
        for name, module in modules.items():
            src = rt.graph.modules[name].state_dict()
            for k, t in module.state_dict().items():
                t.copy_(src[k])
    for name, opt in opts.items():
        src = rt.optimizers[name]
        opt.count, opt.lr = src.count, src.lr
        for p, q in zip(opt.params, src.params):
            opt.opt.state[p] = {k: v.to("cpu", copy=True)
                                for k, v in src.opt.state.get(q, {}).items()}


def async_checkpoint_check(trees, recipe) -> None:
    """Train chunk 1 through a ChunkRuntime, copy its state to the host
    just after `run_task` returns, and start chunk 2 at once, so that its
    steps run while chunk 1's snapshot is written.  After `wait()`, chunk
    1's checkpoints are byte-equal to what the synchronous writer makes
    from the host copy."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import checkpoint as ckpt
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    r = RECIPES[recipe]
    out = os.path.join(WORK, f"async_ckpt_{recipe}")
    os.makedirs(out)
    cfg = ft.write_train_cfg(trees[r["corpus"]], out,
                             os.path.join(out, "run.cfg"), _cuts(recipe),
                             recipe=ft.recipe_cfg(recipe))
    exp, plan = ft.train_plan(cfg)
    first, second = [t for t in plan.epochs[0].tasks if t.phase == "train"][:2]
    rt = ChunkRuntime(exp, "cuda")
    kw = dict(epoch_lr={a: s.lr[0] for a, s in exp.archs.items()},
              batch_size=exp.batches.batch_size_train[0])
    chunk1, chunk2 = rt.load_task_chunk(first), rt.load_task_chunk(second)
    host_modules, host_opts = _host_twin(exp, chunk1)
    res1 = rt.run_task(first, chunk=chunk1, **kw)
    t0 = time.perf_counter()
    _copy_to_host(rt, host_modules, host_opts)
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = rt.run_task(second, chunk=chunk2, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rt.checkpointer.wait()
    w0, w1 = rt.checkpointer.write_spans[0]
    ref = {a: os.path.join(out, f"sync_{a}.ckpt") for a in first.ckpt_files}
    ckpt.save_all(ref, host_modules, host_opts)
    sizes = []
    for arch, path in first.ckpt_files.items():
        with open(path, "rb") as f, open(ref[arch], "rb") as g:
            got, want = f.read(), g.read()
        check(got == want, f"{recipe} chunk 1's asynchronous checkpoint of "
              f"{arch} ({len(got)} bytes) differs from the synchronous "
              f"writer's on a host copy ({len(want)} bytes)")
        sizes.append(len(got))
    print(f"async checkpoint {recipe}: chunk 1's {len(sizes)} checkpoints "
          f"({sum(sizes)} bytes) byte-equal to the synchronous writer's from "
          f"a host copy ({t_copy:.3f} s); ckpt_block "
          f"{res1.phases['ckpt_block']:.3f} s; writer "
          f"{w1 - w0:.3f} s beside chunk 2's wall {t1 - t0:.3f} s (.info "
          f"{res2.elapsed:.3f} s), overlapping {max(0.0, min(w1, t1) - max(w0, t0)):.3f} s;"
          f" chunk 2 dispatch {res2.phases['dispatch']:.3f} s", flush=True)


@contextlib.contextmanager
def _scan_relu(record=None, grads=None, decide=None):
    """The liGRU layers' relu on the plain path (`ligru_impl = scan`: one
    call of `ligru_recurrence_ref` with its default relu a layer), layer by
    layer in forward order: `record` gets each layer's candidate
    pre-activations a_h (T, B', H), `grads` each layer's gradient reaching
    relu(a_h) once the backward has run, and `decide`, a (where, relu')
    pair of (T, B', H) bool tensors a layer, sets relu'(a_h), and so
    relu(a_h) = a_h relu'(a_h), at the elements `where` selects."""
    from tpukaldi_torch.models import recurrent

    scan = recurrent.ligru_recurrence_ref
    layers = []

    def patched(ff, u, mask, act=torch.relu, ln=None):
        if act is not torch.relu or ln is not None:
            return scan(ff, u, mask, act, ln)
        i, a_seq, g_seq = len(layers), [], {}
        layers.append((a_seq, g_seq))

        def relu(a):
            t = len(a_seq)
            a_seq.append(a.detach())
            if decide is None:
                out = torch.relu(a)
            else:
                where, pos = decide[i]
                out = torch.where(torch.where(where[t], pos[t], a > 0), a,
                                  torch.zeros_like(a))
            if grads is not None:
                out.register_hook(lambda g: g_seq.__setitem__(t, g.detach()))
            return out

        return scan(ff, u, mask, relu)

    recurrent.ligru_recurrence_ref = patched
    try:
        yield
    finally:
        recurrent.ligru_recurrence_ref = scan
    for a_seq, g_seq in layers:
        if record is not None:
            record.append(torch.stack(a_seq))
        if grads is not None:
            zero = torch.zeros_like(a_seq[0])
            grads.append(torch.stack([g_seq.get(t, zero)
                                      for t in range(len(a_seq))]))


@contextlib.contextmanager
def _k1b_relu(record):
    """K1b's relu decisions, a (T, B', H) bool tensor a liGRU layer in
    forward order: relu'(a_h) as the kernel took it, read where the
    gradient it passes on to a_h (dff[..., :H]) is not zero."""
    from tpukaldi_torch.kernels import ligru

    kernel = ligru.ligru_recurrence_bwd
    calls = []

    def bwd(ff, h, g, u, mask):
        out = kernel(ff, h, g, u, mask)
        calls.append(out[0][..., :ff.shape[-1] // 2] != 0)
        return out

    ligru.ligru_recurrence_bwd = bwd
    try:
        yield
    finally:
        ligru.ligru_recurrence_bwd = kernel
    record.extend(reversed(calls))


# a liGRU relu decision counts where the float64 gradient reaching relu(a_h)
# exceeds this share of the layer's largest: below it a flipped decision
# moves no gradient beyond float32's rounding, and K1b's dff, from which
# its decisions are read, can round to 0 there whatever relu' is (a gate z
# that rounds to 1 in the kernel makes 1 - z vanish: seen at g = 3e-13)
RELU_G_FLOOR = 1e-6


def _relu_ties(recipe, path, pos, a_r, g_r, a_s):
    """Where a path's liGRU relu decisions `pos` differ from the float64
    run's (pre-activations `a_r`), on the elements whose relu output the
    loss depends on (`g_r` above RELU_G_FLOOR of its layer's largest): a
    (where, pos) pair a layer, and each such element as (layer, t, b',
    unit, a_h in float64).  Each must be a near tie: |a_h| within the plain
    float32 path's own error of a_h in that layer (`a_s` against `a_r`),
    else the check fails."""
    check(len(pos) == len(a_r) == len(g_r) == len(a_s),
          f"{recipe}: relu decisions of {len(pos)} {path} path layers, "
          f"{len(a_r)} float64 layers")
    decide, ties = [], []
    for i, (p, a, g, a32) in enumerate(zip(pos, a_r, g_r, a_s)):
        where = (p != (a > 0)) & (g.abs() > RELU_G_FLOOR * g.abs().max())
        err = (a32.double() - a).abs().max().item()
        worst = a[where].abs().max().item() if where.any() else 0.0
        at = (a.abs() * where).flatten().argmax().item()
        check(worst <= err,
              f"{recipe}: the {path} path's relu decision in layer {i} "
              f"differs from float64's at |a_h| = {worst}, beyond the plain "
              f"float32 path's own error of a_h in that layer, {err} (the "
              f"float64 gradient at relu(a_h) there: "
              f"{g.flatten()[at].item():.3e}, the layer's largest "
              f"{g.abs().max().item():.3e})")
        decide.append((where, p))
        ties += [(i, *idx, a[tuple(idx)].item())
                 for idx in where.nonzero().tolist()]
    return decide, ties


def step_check(modules, trees, recipe) -> None:
    """One full-width train step of the recipe at drop 0, on the first batch
    of the main path's first train chunk (the device cache's on the card):
    the kernel path's loss and gradients, and the plain path's, held to a
    float64 run of the plain float32 arithmetic (for the QLSTM,
    `qlstm_impl = scan` through the plain versions).  A liGRU layer's relu
    decision where a_h lies within float32's error of 0 is a coin toss
    that moves a gradient by ~1e-2 (the padding rows hold ~2,000 such
    a_h in layer 0): each path is held to a float64 run that takes the
    path's own decision at each element where it differs from float64's,
    and each such element must be a near tie (`_relu_ties`)."""
    from tpukaldi_torch.tools import flagship_tree as ft

    # the port's own setting (`resolve_device` pins it); this script sets
    # no precision flag itself
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 GEMMs and convolutions must not run in TF32 in the step "
          "check")
    tree = trees[RECIPES[recipe]["corpus"]]
    src = ft.recipe_cfg(recipe)
    out_step = os.path.join(WORK, f"train_{recipe}_step")
    os.makedirs(out_step, exist_ok=True)
    cuts = {**_cuts(recipe), **_no_drop(recipe)}
    cfg_k = ft.write_train_cfg(tree, out_step, os.path.join(out_step, "k.cfg"),
                               cuts, recipe=src)
    cfg_s = ft.write_train_cfg(tree, out_step, os.path.join(out_step, "s.cfg"),
                               {**cuts, **_plain_replace(recipe)}, recipe=src)
    # the raw recipes' conv biases sit before a layer norm, whose mean
    # cancels them
    held_step(modules, recipe, recipe, cfg_k, cfg_s,
              r"\w+\.conv\.\d+\.bias" if _raw(recipe) else None)


def held_step(modules, recipe, label, cfg_k, cfg_s, inert_re=None) -> None:
    """`step_check`'s rule on one pair of cfgs at drop 0 (the kernel path's
    and the plain path's, which differ in the recipe's `*_impl`), printed
    under `label`: their loss within STEP_LOSS_ATOL, the kernel path's
    gradients within STEP_GRAD_FACTOR times the plain path's distance from
    a float64 step (for the liGRU each path's own relu decisions at its
    near ties).  `recipe` names the recurrence (its plain path).  The
    parameters `inert_re` matches have no gradient (a bias that a
    normalisation's mean cancels): they are held to be tiny instead."""
    from tpukaldi_torch.tools import flagship_tree as ft

    relu_k, a_s, a_r, g_r = [], [], [], []
    with _k1b_relu(relu_k):
        loss_k, grads_k, shape = ft.train_step_gradients(cfg_k, "cuda")
    # the QLSTM's plain path is its kernel path's cfg through the plain
    # versions; a TIMIT recipe's is `*_impl = scan`
    plain_ctx, plain_label = _plain_path(recipe, modules)
    with plain_ctx, _scan_relu(record=a_s):
        loss_s, grads_s, _ = ft.train_step_gradients(
            cfg_k if recipe == "QLSTM" else cfg_s, "cuda")
    with _plain_path(recipe, modules)[0], _scan_relu(record=a_r, grads=g_r):
        loss_r, grads_r, _ = ft.train_step_gradients(cfg_s, "cuda",
                                                     torch.float64)
    # each path's float64 run with its own relu decisions at near ties
    refs, ties = {}, {}
    for path, pos in (("kernel", relu_k), ("plain", [a > 0 for a in a_s])):
        decide, ties[path] = _relu_ties(label, path, pos, a_r, g_r, a_s)
        refs[path] = grads_r
        if ties[path]:
            with _plain_path(recipe, modules)[0], _scan_relu(decide=decide):
                _, refs[path], _ = ft.train_step_gradients(
                    cfg_s, "cuda", torch.float64)

    # a bias before a normalisation has an exactly zero gradient (float64
    # gives 1e-16 of noise, float32 1e-7, K6 an exact zero), so it is held
    # to be tiny, not to a relative error
    inert = {n for n in grads_k if inert_re and re.fullmatch(inert_re, n)}
    top = max(g.double().abs().max().item() for g in grads_r.values())
    for grads in (grads_k, grads_s):
        for n in inert:
            check(grads[n].abs().max().item() <= 1e-5 * top,
                  f"{label}: {n} should be ~0, is {grads[n].abs().max()}")

    def worst(grads, ref):
        """(max over tensors of max|g - ref| / max|ref|, that tensor)"""
        rel = {name: ((g.double() - ref[name].double()).abs().max()
                      / ref[name].double().abs().max().clamp_min(1e-30)).item()
               for name, g in grads.items() if name not in inert}
        name = max(rel, key=rel.get)
        check(all(math.isfinite(r) for r in rel.values()),
              "non-finite gradient error")
        return rel[name], name

    err_k, name_k = worst(grads_k, refs["kernel"])
    err_s, name_s = worst(grads_s, refs["plain"])
    err_ks, name_ks = worst(grads_k, grads_s)
    loss_err = abs(loss_k - loss_s)
    against, tie_note = "float64", ""
    if relu_k:
        against += " with each path's own relu decisions at its ties"
        raw_k, raw_s = worst(grads_k, grads_r), worst(grads_s, grads_r)
        listed = {path: ", ".join(f"({i}, {t}, {b}, {j}, {a:.3e})"
                                  for i, t, b, j, a in found[:8])
                  for path, found in ties.items()}
        tie_note = (
            "; relu decisions unlike float64's (layer, t, b', unit, a_h): "
            + "; ".join(f"{path} path {len(ties[path])} {listed[path]}"
                        for path in ties)
            + f"; against the float64 run's own decisions: kernel path "
            f"{raw_k[0]:.3e} ({raw_k[1]}), plain path {raw_s[0]:.3e} "
            f"({raw_s[1]})")
    print(f"training {label} step at drop 0 (batch {tuple(shape)}, "
          f"{len(grads_k)} gradients): loss kernel {loss_k:.7f} plain "
          f"{loss_s:.7f} float64 {loss_r:.7f}, kernel vs plain |diff|="
          f"{loss_err:.3e} (atol {STEP_LOSS_ATOL:g}); worst gradient error vs "
          f"{against}: kernel path {err_k:.3e} ({name_k}), plain path "
          f"({plain_label}) {err_s:.3e} ({name_s}) (factor "
          f"{STEP_GRAD_FACTOR:g}); kernel vs plain {err_ks:.3e} ({name_ks})"
          + tie_note, flush=True)
    check(loss_err <= STEP_LOSS_ATOL,
          f"{label} train step loss differs by {loss_err}")
    check(err_k <= STEP_GRAD_FACTOR * err_s,
          f"{label} kernel path gradients {err_k} from float64, plain path {err_s}")


def _zoo_no_drop(src):
    """cfg replacements setting every dropout rate of the recipe to 0."""
    with open(src) as f:
        text = f.read()
    return {m.group(0): f"{m.group(1)} = " + ",".join(
        "0.0" for _ in m.group(2).split(","))
        for m in re.finditer(r"^(\w*drop\w*) = (.+)$", text, re.M)}


def _zoo_depth(src, replace, depth):
    """`replace` (cfg line -> line) with the recurrent architecture cut to
    its first `depth` layers: a `*num_layers` count becomes `depth`, and
    every per-layer list of [architecture1] (as long as its `*_lay` list)
    keeps its first `depth` entries, after the replacement already given."""
    with open(src) as f:
        text = f.read()
    section = text.split("[architecture1]", 1)[1].split("\n[", 1)[0]
    lines = re.findall(r"^(\w+) = (.+)$", section, re.M)
    lay = [v for k, v in lines if k.endswith("_lay")]
    n = len(lay[0].split(",")) if lay else 0
    out = dict(replace)
    for key, value in lines:
        line = f"{key} = {value}"
        cur = out.get(line, line)
        val = cur.split(" = ", 1)[1]
        if key.endswith("num_layers"):
            out[line] = f"{key} = {depth}"
        elif n > depth and len(val.split(",")) == n:
            out[line] = f"{key} = " + ",".join(val.split(",")[:depth])
    return out


def _zoo_cfg(tree, cls, out, name, replace):
    """A zoo class's training cfg over `tree`, with the corpus's cuts, a
    batch of 8 utterances, the class swapped in and `replace`."""
    from tpukaldi_torch.tools import flagship_tree as ft

    corpus, recipe, swap = ZOO[cls]
    src = ft.recipe_cfg(recipe)
    with open(src) as f:
        text = f.read()
    cuts = {k: v for k, v in {**_cuts_for(corpus), **ZOO_CUTS}.items()
            if k in text}
    os.makedirs(out, exist_ok=True)
    return ft.write_train_cfg(tree, out, os.path.join(out, name),
                              {**cuts, **swap, **replace}, recipe=src)


def _warm_ms(fn) -> float:
    """One call of fn after a warm one, between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class _K1Calls:
    """Records K1f's calls (inputs and output) while in place: the wrapper
    the fusion layers reach through `LiGRURecurrence`."""

    def __init__(self, ligru):
        self.ligru, self.calls = ligru, []

    def __enter__(self):
        self.saved = self.ligru.ligru_recurrence

        def record(ff, u, mask):
            h = self.saved(ff, u, mask)
            self.calls.append((ff.detach(), u.detach(), mask.detach(),
                               h.detach()))
            return h

        self.ligru.ligru_recurrence = record
        return self

    def __exit__(self, *exc):
        self.ligru.ligru_recurrence = self.saved


def zero_row_check(twins, inputs, out_name, cls) -> str:
    """The step check's batch served as a forward batch is padded: its last
    row cut to length 0 and zeroed.  The card's posteriors are held to the
    CPU twin's on the valid frames (POSTERIOR_ATOL), and every frame of
    them, padding included, must be finite."""
    from tpukaldi_torch.train.step import forward_step

    t0 = time.perf_counter()
    feats, _, lengths = inputs["cpu"]
    feats, lengths = feats.clone(), lengths.clone()
    feats[:, -1] = 0.0
    lengths[-1] = 0
    post = {d: forward_step(twins[d].graph, feats.to(twins[d].device),
                            lengths.to(twins[d].device))[out_name].cpu()
            for d in ("card", "cpu")}
    valid = (torch.arange(feats.shape[0])[:, None]
             < lengths[None, :]).reshape(-1)
    err = float((post["card"][valid] - post["cpu"][valid]).abs().max())
    check(bool(torch.isfinite(post["card"]).all()),
          f"{cls}: non-finite forward with a row of length 0")
    check(err <= POSTERIOR_ATOL,
          f"{cls}: card vs CPU forward with a row of length 0 {err}")
    return (f"; a forward batch with a row of length 0 (lengths "
            f"{lengths.tolist()}): max_abs_err={err:.3e} on the valid frames "
            f"(atol {POSTERIOR_ATOL:g}), all {post['card'].shape[0]} frames "
            f"finite, {time.perf_counter() - t0:.2f} s")


def zoo_step_check(modules, cfg, cls, card="cuda") -> dict:
    """One class at full width: the card's train step and forward with
    lengths against a CPU twin from the cfg's seed, and their times."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime
    from tpukaldi_torch.train.step import forward_step, train_step

    t_start = time.perf_counter()
    exp, plan = ft.train_plan(cfg)
    task = plan.epochs[0].tasks[0]
    # the card's runtime and its CPU twin, each seeded from the cfg
    twins = {"card": chunk_runtime.ChunkRuntime(exp, card),
             "cpu": chunk_runtime.ChunkRuntime(exp, "cpu")}
    chunk = twins["cpu"].load_task_chunk(task)
    for rt in twins.values():
        rt.ensure_initialized(chunk, with_optimizers=True)
    bs = twins["cpu"]._effective_bs(chunk, exp.batches.batch_size_train[0])
    batch = next(twins["cpu"]._batches(chunk, bs, True, task.seed))
    frames = int(batch.lengths.sum())
    inputs = {d: tuple(torch.from_numpy(np.asarray(a)).to(rt.device) for a in
                       (batch.feats, batch.labs, batch.lengths))
              for d, rt in twins.items()}
    out_name = exp.forward.outs[0]

    # the forward with lengths (eval mode, the seeded weights)
    def fwd(d):
        feats, _, lengths = inputs[d]
        return forward_step(twins[d].graph, feats, lengths)[out_name]

    k1 = None
    with _K1Calls(modules["ligru"]) as rec:
        post = fwd("card")
    if cls == "fusionRNN":
        check(len(rec.calls) == FUSION_LAYERS,
              f"fusionRNN forward: {len(rec.calls)} K1f calls, expected "
              f"{FUSION_LAYERS}")
        k1 = max(float((h - modules["ligru"].ligru_recurrence_ref(
            ff, u, mask)).abs().max()) for ff, u, mask, h in rec.calls)
        check(k1 <= KERNEL_ATOL, f"fusionRNN: K1f vs its plain version {k1}")
    else:
        check(not rec.calls, f"{cls} forward called K1f")
    post_cpu = fwd("cpu")
    T, B = batch.feats.shape[:2]
    valid = (torch.arange(T)[:, None] < torch.from_numpy(
        np.asarray(batch.lengths))[None, :]).reshape(-1)
    fwd_err = float((post.cpu()[valid] - post_cpu[valid]).abs().max())
    check(bool(torch.isfinite(post).all()), f"{cls}: non-finite forward")
    check(fwd_err <= POSTERIOR_ATOL,
          f"{cls}: card vs CPU forward (valid frames) {fwd_err}")
    fwd_ms = _warm_ms(lambda: fwd("card"))
    zero_row = (zero_row_check(twins, inputs, out_name, cls)
                if cls.endswith("_cudnn") else "")

    # one train step at drop 0
    def step(d):
        feats, labs, _ = inputs[d]
        return train_step(twins[d].graph, twins[d].optimizers, feats, labs,
                          batch.n_valid_t, twins[d].generator)

    t_cpu = time.perf_counter()
    losses = {"cpu": step("cpu")[0].item()}
    t_cpu = time.perf_counter() - t_cpu
    losses["card"] = step("card")[0].item()
    if k1 is not None:
        # the K1 path's reference: the CPU twin in float64 (the heads'
        # log-softmax and the costs stay float32, as in tpukaldi)
        twins["cpu64"] = chunk_runtime.ChunkRuntime(exp, "cpu")
        twins["cpu64"].ensure_initialized(chunk, with_optimizers=True)
        for module in twins["cpu64"].graph.modules.values():
            module.to(torch.float64)
        feats, labs, lengths = inputs["cpu"]
        inputs["cpu64"] = (feats.double(), labs, lengths)
        losses["cpu64"] = step("cpu64")[0].item()
    grads = {d: {f"{a}.{n}": p.grad.detach().cpu().clone()
                 for a, m in twins[d].graph.modules.items()
                 for n, p in m.named_parameters()} for d in twins}
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    inert = sorted(n for n in grads["cpu"] if ZOO_INERT.fullmatch(n))
    for n in inert:
        for d in twins:
            check(float(grads[d][n].abs().max()) <= ZOO_INERT_RTOL * top,
                  f"{cls}: {n} should be ~0 on {d}, is "
                  f"{float(grads[d][n].abs().max())}")
    scale = {}
    for n, g in grads["cpu"].items():
        arch = n.split(".")[0]
        scale[arch] = max(scale.get(arch, 0.0), float(g.abs().max()))

    def errors(got, ref, by_arch):
        """{tensor: max|got - ref| over the largest |ref| of its
        architecture (by_arch) or of its own}"""
        return {n: float((g.double() - ref[n].double()).abs().max())
                / max(scale[n.split(".")[0]] if by_arch
                      else float(ref[n].abs().max()), 1e-30)
                for n, g in got.items() if n not in inert}

    rel = errors(grads["card"], grads["cpu"], True)
    own = errors(grads["card"], grads["cpu"], False)
    worst, worst_own = max(rel, key=rel.get), max(own, key=own.get)
    loss_err = abs(losses["card"] - losses["cpu"])
    check(all(math.isfinite(r) for r in rel.values()), f"{cls}: non-finite grad")
    check(loss_err <= STEP_LOSS_ATOL, f"{cls}: train loss differs by {loss_err}")
    if k1 is None:
        check(rel[worst] <= ZOO_GRAD_RTOL,
              f"{cls}: gradient {worst} differs by {rel[worst]} of its "
              f"architecture's largest")
        against = ""
    else:
        # K1b rematerialises the gates in its own sum order, so a relu
        # argument within rounding of 0 may flip against the forward's and
        # reroute one element's gradient: the card is held, as
        # `step_check` holds the liGRU recipe, to the float64 run, at most
        # STEP_GRAD_FACTOR times as far from it as the CPU twin
        e_card = errors(grads["card"], grads["cpu64"], False)
        e_cpu = errors(grads["cpu"], grads["cpu64"], False)
        n_card, n_cpu = max(e_card, key=e_card.get), max(e_cpu, key=e_cpu.get)
        check(e_card[n_card] <= STEP_GRAD_FACTOR * e_cpu[n_cpu],
              f"{cls}: card gradients {e_card[n_card]} from float64, the CPU "
              f"twin's {e_cpu[n_cpu]}")
        against = (f"; vs float64 (loss {losses['cpu64']:.7f}): card "
                   f"{e_card[n_card]:.3e} ({n_card}), CPU {e_cpu[n_cpu]:.3e} "
                   f"({n_cpu}) (factor {STEP_GRAD_FACTOR:g})")
    step_ms = _warm_ms(lambda: step("card"))
    zoo_graph_check(twins["card"], batch, *inputs["card"][:2], cls)
    print(f"zoo {cls} ({os.path.basename(ft.recipe_cfg(ZOO[cls][1]))}"
          f"{', ' + cls + ' swapped in' if ZOO[cls][2] else ''}): batch "
          f"{tuple(batch.feats.shape)}, {frames} frames; train step at drop 0 "
          f"loss card {losses['card']:.7f} CPU {losses['cpu']:.7f} |diff|="
          f"{loss_err:.3e} (atol {STEP_LOSS_ATOL:g}), worst gradient "
          f"{rel[worst]:.3e} of its architecture's largest ({worst}"
          + (f"; rtol {ZOO_GRAD_RTOL:g}" if k1 is None else "")
          + f"), {own[worst_own]:.3e} of its own max "
          f"({worst_own}) over {len(rel)} tensors{against}"
          + (f" (and {len(inert)} biases before a batchnorm ~0: within "
             f"{ZOO_INERT_RTOL:g} of the largest gradient)" if inert else "")
          + f"; forward with lengths max_abs_err={fwd_err:.3e} "
          f"on the valid frames (atol {POSTERIOR_ATOL:g})"
          + (f"; K1f on the fusion layers vs ligru_recurrence_ref "
             f"max_abs_err={k1:.3e} (atol {KERNEL_ATOL:g})" if k1 is not None
             else "") + zero_row, flush=True)
    print(f"zoo {cls} speed: train step {step_ms:.2f} ms "
          f"({frames / step_ms * 1e3:.1f} frames/s), forward {fwd_ms:.2f} ms "
          f"({frames / fwd_ms * 1e3:.1f} frames/s); the CPU twin's train step "
          f"{t_cpu:.1f} s; the check {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return {"step_ms": step_ms, "fwd_ms": fwd_ms, "frames": frames,
            "k1_err": k1}


def fusion_run_phase(modules, tree) -> dict:
    """fusionRNN through run_exp on the card: one train chunk and the
    forward stage, then production serving from seeded finals; K1f and K1b
    counted, arks held to the CPU path."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    n_test = ZOO_TREE["splits"]["test"][0]
    src = ft.recipe_cfg("fusionRNN")
    out = os.path.join(WORK, "zoo_fusion_train")
    os.makedirs(out)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             FUSION_RUN_CUTS, recipe=src)
    _reset_counts(modules, chunk_runtime)
    t0 = time.perf_counter()
    exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts(modules)
    # fusionRNN's recurrence runs the liGRU's kernels, and no other
    _check_only(counts, "liGRU", "fusionRNN training")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)
    fwd, bwd = counts["ligru_fwd"], counts["ligru_bwd"]
    check(n_train > 0 and fwd == FUSION_LAYERS * (n_train + n_valid + n_fwd),
          f"fusionRNN training: K1f {fwd}, expected {FUSION_LAYERS} x "
          f"({n_train} + {n_valid} + {n_fwd})")
    check(bwd == FUSION_LAYERS * n_train,
          f"fusionRNN training: K1b {bwd}, expected {FUSION_LAYERS} x {n_train}")
    with open(os.path.join(out, "res.res")) as f:
        ep = [line for line in f.read().splitlines() if line.startswith("ep=")]
    check(len(ep) == 1 and math.isfinite(float(ep[0].split(" loss=")[1]
                                                .split()[0])),
          f"fusionRNN res.res: {ep}")
    names, lengths = _check_arks(list(ft.forward_outputs(out)[0]), n_test)
    cpu = _check_cpu_path(ft, exp, out, names, lengths, "fusionRNN")
    print(f"zoo fusionRNN training (run_exp, 1 train chunk of "
          f"{ZOO_TREE['splits']['train'][0]} utterances, then the forward "
          f"stage): {n_train} train + {n_valid} valid + {n_fwd} forward "
          f"batches, K1f launches {fwd} (= {FUSION_LAYERS} x "
          f"{n_train + n_valid + n_fwd}), K1b launches {bwd} (= "
          f"{FUSION_LAYERS} x {n_train}); wall {wall:.3f} s; {ep[0]}; arks "
          f"{n_test} finite; CUDA vs CPU path (2 utterances) {cpu}", flush=True)
    export = _timed("zoo fusionRNN export", export_check, modules, cfg,
                    "zoo fusionRNN export", FUSION_LAYERS)

    out_s = os.path.join(WORK, "zoo_fusion_serve")
    os.makedirs(out_s)
    cfg_s = ft.write_prod_cfg(tree, out_s, os.path.join(out_s, "run.cfg"),
                              recipe=src)
    ft.save_seeded_finals(cfg_s, dim=ZOO_TREE["dim"])
    _reset_counts(modules, chunk_runtime)
    t0 = time.perf_counter()
    exp_s = run_experiment(cfg_s, device="cuda")
    wall_s = time.perf_counter() - t0
    counts_s = _counts(modules)
    _check_only(counts_s, "liGRU", "fusionRNN serving")
    n_fwd_s = chunk_runtime.forward_batches
    check(counts_s["ligru_fwd"] == FUSION_LAYERS * n_fwd_s
          and counts_s["ligru_bwd"] == 0,
          f"fusionRNN serving: K1f {counts_s['ligru_fwd']}, K1b "
          f"{counts_s['ligru_bwd']}, expected {FUSION_LAYERS} x {n_fwd_s}, 0")
    posts, info = ft.forward_outputs(out_s)
    names, lengths = _check_arks(list(posts), n_test)
    cpu_s = _check_cpu_path(ft, exp_s, out_s, names, lengths, "fusionRNN")
    print(f"zoo fusionRNN serving (run_exp): {n_test} utterances, "
          f"{int(info['frames'])} frames, {n_fwd_s} forward batches, K1f "
          f"launches {counts_s['ligru_fwd']}, K1b 0; forward stage "
          f"{info['elapsed_time_chunk']:.3f} s, {info['frames_per_sec']:.1f} "
          f"frames/s (.info), wall {wall_s:.3f} s; CUDA vs CPU path (2 "
          f"utterances) {cpu_s}", flush=True)
    return {"ligru_fwd": {"fusion_launches": fwd + counts_s["ligru_fwd"],
                          "fusion_export_launches": export},
            "ligru_bwd": {"fusion_launches": bwd}}


def cudnn_run_phase(modules) -> None:
    """cfg/TIMIT/LSTM_fmllr_cudnn.cfg at full width (4 x 550,
    bidirectional) through run_exp on the card: one train chunk, its valid
    chunk and the forward stage over a test split that leaves forward
    batches padded with rows of length 0.  No hand kernel launches (the
    family is torch's cuDNN RNN); arks finite and held to the CPU path;
    the forward's frames/s from its .info; cuDNN compacts no weights; the
    arch's forward and train step timed beside torch's own module over the
    same weights (flattened, all layers at once); then the trained run
    exported and served (`export_check`)."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    t0 = time.perf_counter()
    tree = ft.write_kaldi_tree(
        os.path.join(WORK, "cudnn"), dim=CUDNN_TREE["dim"], n_phones=N_PHONES,
        n_pdfs=N_PDFS, splits=CUDNN_TREE["splits"])
    n_test = CUDNN_TREE["splits"]["test"][0]
    out = os.path.join(WORK, "zoo_lstm_cudnn_run")
    os.makedirs(out)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             CUDNN_RUN_CUTS,
                             recipe=ft.recipe_cfg("LSTM_cudnn"))
    _reset_counts(modules, chunk_runtime)
    t1 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        exp = run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t1
    counts = _counts(modules)
    check(not any(counts.values()), f"LSTM_cudnn run: hand kernels launched "
          f"{ {k: n for k, n in counts.items() if n} }")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)
    check(n_train > 0 and n_fwd * chunk_runtime.DEFAULT_FORWARD_BATCH > n_test,
          f"LSTM_cudnn run: {n_train} train batches, {n_fwd} forward batches "
          f"for {n_test} utterances (no row of length 0)")
    with open(os.path.join(out, "res.res")) as f:
        ep = [line for line in f.read().splitlines() if line.startswith("ep=")]
    check(len(ep) == 1 and math.isfinite(float(ep[0].split(" loss=")[1]
                                                .split()[0])),
          f"LSTM_cudnn res.res: {ep}")
    posts, info = ft.forward_outputs(out)
    names, lengths = _check_arks(list(posts), n_test)
    cpu = _check_cpu_path(ft, exp, out, names, lengths, "LSTM_cudnn",
                          float64=True)
    cudnn_warnings = sorted({str(w.message)[:90] for w in warned
                             if "cuDNN" in str(w.message)
                             or "contiguous chunk" in str(w.message)})
    # each layer takes its own flattened weights as they lie
    check(not any("contiguous chunk" in w for w in cudnn_warnings),
          f"LSTM_cudnn run: cuDNN compacted the weights: {cudnn_warnings}")
    recipe = os.path.basename(ft.recipe_cfg("LSTM_cudnn"))
    print(f"zoo LSTM_cudnn run (run_exp, {recipe} at 4 x 550 "
          f"bidirectional, 1 train chunk of "
          f"{CUDNN_TREE['splits']['train'][0]} utterances, then the forward "
          f"stage over {n_test} in {n_fwd} batches of 8): {n_train} train + "
          f"{n_valid} valid + {n_fwd} forward batches, no hand kernel "
          f"launched; wall {wall:.3f} s; {ep[0]}; arks {n_test} finite; "
          f"forward stage {info['elapsed_time_chunk']:.3f} s, "
          f"{int(info['frames'])} frames, {info['frames_per_sec']:.1f} "
          f"frames/s (.info); CUDA vs CPU path (2 utterances) {cpu}; cuDNN "
          f"warnings {cudnn_warnings or 'none'}", flush=True)
    _timed("zoo LSTM_cudnn arch vs torch's module", cudnn_module_timing,
           exp, out)
    _timed("zoo LSTM_cudnn export", export_check, modules, cfg,
           "zoo LSTM_cudnn export", 0)
    print(f"zoo LSTM_cudnn run phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


def cudnn_module_timing(exp, out) -> None:
    """The trained LSTM_cudnn arch (one call per layer, both directions,
    each layer on its own flattened weights) against torch's `nn.LSTM` over the same
    weights flattened into one buffer, all layers in one call, on a
    full-length (778, 8, 40) batch: the no-grad forward's times and max
    difference, and a train forward and backward's times (dropout 0)."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime

    _, plan = ft.train_plan(os.path.join(out, "run.cfg"))
    task = plan.forward_tasks[0]
    rt = chunk_runtime.ChunkRuntime(exp, "cuda")
    rt.ensure_initialized(rt.load_task_chunk(task))
    rt.restore_from(task.pretrain_files, every_rank=False)
    (arch,) = [m for m in rt.graph.modules.values()
               if type(m).__name__ == "LSTM_cudnn"]
    arch.eval()
    device = next(arch.parameters()).device
    x = torch.randn((778, 8, arch.inp_dim),
                    generator=torch.Generator().manual_seed(3)).to(device)
    lengths = torch.full((8,), 778, dtype=torch.int32, device=device)
    lib = copy.deepcopy(arch.torch_rnn())
    lib.flatten_parameters()
    with torch.no_grad():
        got, want = arch(x, lengths), lib(x)[0]
        ms = _warm_ms(lambda: arch(x, lengths))
        lib_ms = _warm_ms(lambda: lib(x))
    err = float((got - want).abs().max())
    check(err <= POSTERIOR_ATOL, f"LSTM_cudnn arch vs torch's module {err}")
    arch.train()
    lib.train()
    arch.dropout = lib.dropout = 0.0

    def train_ms(forward):
        def step():
            forward().sum().backward()
        step()
        return _warm_ms(step)

    train, lib_train = train_ms(lambda: arch(x)), train_ms(lambda: lib(x)[0])
    print(f"zoo LSTM_cudnn arch forward (778, 8, {arch.inp_dim}) at 4 x 550 "
          f"bidirectional: {ms:.3f} ms layer by layer through the op, "
          f"torch's nn.LSTM over the flattened weights {lib_ms:.3f} ms "
          f"({ms / lib_ms:.2f}x), max_abs_err={err:.3e}; train forward and "
          f"backward {train:.3f} ms layer by layer, torch's nn.LSTM "
          f"{lib_train:.3f} ms ({train / lib_train:.2f}x)", flush=True)


def zoo_phase(modules, trees) -> dict:
    """The rest of the shipped zoo on the card: each class's step check,
    then fusionRNN through run_exp and its export, then LSTM_cudnn's recipe
    through run_exp and its export.  Returns K1's launches on the fusion
    path (the kernels line's extra keys)."""
    from tpukaldi_torch.tools import flagship_tree as ft

    # the port's own setting (`resolve_device` pins it): the *_cudnn
    # classes' cuDNN RNNs run in float32, not TF32
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "cuDNN's RNNs and the GEMMs must not run in TF32 in the zoo phase")
    t0 = time.perf_counter()
    trees = {**trees, "DIRHA6": ft.write_kaldi_tree(
        os.path.join(WORK, "dirha6"), dim=ZOO_TREE["dim"], n_phones=N_PHONES,
        n_pdfs=N_PDFS, splits=ZOO_TREE["splits"], corpus="DIRHA")}
    for cls, (corpus, recipe, _) in ZOO.items():
        out = os.path.join(WORK, f"zoo_{cls}")
        src = ft.recipe_cfg(recipe)
        replace = _zoo_no_drop(src)
        if cls != "fusionRNN":
            # the classes without a kernel at ZOO_DEPTH of their layers
            replace = _zoo_depth(src, replace, ZOO_DEPTH)
        cfg = _zoo_cfg(trees[corpus], cls, out, "step.cfg", replace)
        zoo_step_check(modules, cfg, cls)
    launches = fusion_run_phase(modules, trees["DIRHA6"])
    cudnn_run_phase(modules)
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


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
# projections, the heads, K4b's dU and their backward share cuBLAS kernel
# names
LAYERS = (
    ("K6f", ("conv_ln_fwd_kernel",)),
    ("K6b layer-norm pass", ("conv_ln_bwd_kernel",)),
    ("K5f", ("conv_pool_fwd_kernel",)),
    # dX runs where layer 0's input needs a gradient: in both raw recipes,
    # whose input layer norm (cnn_use_laynorm_inp, sinc_use_laynorm_inp)
    # has a gain and a shift to train
    ("K5b/K6b dX pass", ("conv_pool_dx_tile_kernel",)),
    ("K5b/K6b dW pass, window sums", ("conv_pool_dw_part_kernel",
                                      "reduce_windows_kernel")),
    ("K1f", ("ligru_fwd_kernel",)),
    ("K1b remat", ("ligru_remat_kernel",)),
    ("K1b sequential", ("ligru_bwd_seq_kernel",)),
    ("K2f", ("lstm_fwd_kernel",)),
    ("K2b remat", ("lstm_remat_kernel",)),
    ("K2b sequential", ("lstm_bwd_seq_kernel",)),
    ("K3f", ("gru_fwd_kernel",)),
    ("K3b remat", ("gru_remat_zr_kernel", "gru_remat_a_kernel")),
    ("K3b sequential", ("gru_bwd_seq_kernel",)),
    ("K4f", ("lstm_lean_fwd_kernel",)),
    ("K4b remat", ("lstm_lean_remat_kernel",)),
    ("K4b sequential", ("lstm_lean_bwd_seq_kernel",)),
    ("dU passes (K1b, K2b, K3b)", ("du_tile_kernel",)),
    # cuDNN's convolutions (the raw recipes' layers 1-3) before the GEMM
    # row, whose patterns their names share
    ("cuDNN conv (layers 1-3, forward and backward)",
     ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "cudnn")),
    ("max-pool (layers 1-3)", ("max_pool", "MaxPool")),
    ("cuFFT (logMelFb)", ("fft",)),
    ("GEMM (FF, heads, K4b's dU, their backward)",
     ("gemm", "Gemm", "cutlass", "xmma", "sm90_", "splitKreduce")),
    ("batchnorm", ("batch_norm", "batchnorm", "welford", "bn_")),
    ("optimizer (rmsprop, foreach)", ("multi_tensor_apply", "foreach")),
    ("dropout draws", ("bernoulli", "philox", "distribution")),
    ("device cache gather", ("indexSelect", "index_select",
                             "vectorized_gather")),
    ("H2D copy", ("Memcpy HtoD",)),
    ("D2H copy", ("Memcpy DtoH",)),
)


# the rows of LAYERS that the rate configurations' front ends run (PASE's
# convolutions are cuDNN's), and their liGRU's recurrence
RATE_FRONT_ROWS = ("cuFFT (logMelFb)",
                   "cuDNN conv (layers 1-3, forward and backward)")
RATE_LIGRU_ROWS = ("K1f", "K1b remat", "K1b sequential",
                   "dU passes (K1b, K2b, K3b)")


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
    from tpukaldi_torch.train import chunk_runtime
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    out = os.path.dirname(serve_cfg)
    _drop_forward_ledger(out)
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
    _reset_graph_counts(chunk_runtime)
    torch.cuda.synchronize()
    # epoch 1's first chunk's checkpoint is still being written: the
    # profiled chunk runs beside the writer, as every chunk of a run does
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = rt.run_task(ep1[1], chunk=chunk, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rt.checkpointer.wait()
    spans = rt.checkpointer.write_spans
    print(f"profile {recipe} train chunk: checkpoint writer "
          f"{spans[0][1] - spans[0][0]:.3f} s for the chunk before, "
          f"{spans[1][1] - spans[1][0]:.3f} s for this one", flush=True)
    busy_us, per_op = _device_events(prof)
    label = f"{recipe} train chunk"
    _print_profile(f"{label} (warm)", wall, busy_us, per_op, n_top=5)
    steps = _graph_counts(chunk_runtime)
    print(f"profile {label}: {res.n_batches} steps (at the default "
          f"TPUKALDI_MULTISTEP: captures {steps['graph_captures']}, replays "
          f"{steps['graph_replays']}, eager {steps['eager_steps']}), "
          f"{res.frames} frames, "
          f"{res.frames_per_sec:.1f} frames/s (.info), phases " + " ".join(
              f"{k}={v:.3f}" for k, v in res.phases.items()), flush=True)
    for layer, us in sorted(_by_layer(per_op).items(), key=lambda kv: -kv[1]):
        print(f"profile {label} layer: {layer}: {us / 1e3:.1f} ms "
              f"({us / busy_us:.1%} of busy)", flush=True)
    # where the host's time goes: the top operators by their own CPU time
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        print(f"profile {label} host op: {e.self_cpu_time_total / 1e3:.1f} ms "
              f"self CPU x{e.count} {e.key[:70]}", flush=True)
    with open(os.path.join(WORK, f"profile_{recipe}_train.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=-1))


# the device cache's batches against the host path's: CMVN statistics
# accumulate in another order (tpukaldi's own bound,
# tests/test_device_cache.py); labels, names, lengths exact
CACHE_TOL = 2e-6
# loss and err of a run with the cache on and off, as rtol and atol
# (tests/test_device_cache.py: |on - off| <= 5e-3 + 5e-3 |off|), held on the
# first train chunk's .info: its steps start from the same weights.  Later
# values feed the batches' float32 rounding difference (<= 4.8e-7) back
# through rmsprop and relu near-ties, and the flagship's res.res moves by
# ~2e-2 under a one-ulp change of the host path's own features: the whole
# res.res with the cache is held within RES_SPREAD_FACTOR times the largest
# difference between two host-path runs whose features differ by such a
# change (the unchanged run and RES_SPREAD_SEEDS runs with every feature
# moved one ulp down, kept or moved one ulp up at random, a seed each)
CACHE_RUN_TOL = 5e-3
RES_SPREAD_SEEDS = 3
RES_SPREAD_FACTOR = 2.0


def _res_numbers(out):
    """The loss and err values of a run's `ep=` lines, and each epoch's
    host_load_producer."""
    with open(os.path.join(out, "res.res")) as f:
        lines = f.read().splitlines()
    vals = [float(v) for line in lines if line.startswith("ep=")
            for v in re.findall(r"(?:loss|err)=([\d.]+)", line)]
    producer = [float(re.search(r" host_load_producer=([\d.]+)", line)[1])
                for line in lines if line.startswith("phases ep=")]
    return vals, producer


@contextlib.contextmanager
def _host_features_nudged(seed):
    """The host chunk loader's features each moved one ulp down, kept or
    moved one ulp up at random (numpy's generator at `seed`) for the runs
    inside: a float32 rounding change of the input of the size by which
    the device cache's batches differ from the host path's."""
    from tpukaldi_torch.train import chunk_runtime

    load = chunk_runtime.load_chunk
    rng = np.random.default_rng(seed)

    def nudged(*args, **kwargs):
        chunk = load(*args, **kwargs)
        step = rng.integers(-1, 2, chunk.feats.shape)
        toward = np.where(step > 0, np.float32(np.inf), np.float32(-np.inf))
        chunk.feats = np.where(step == 0, chunk.feats,
                               np.nextafter(chunk.feats, toward))
        return chunk

    chunk_runtime.load_chunk = nudged
    try:
        yield
    finally:
        chunk_runtime.load_chunk = load


def _warm_cache_chunk(cfg, mode):
    """Epoch 1's first train chunk of a finished run on a fresh runtime at
    TPUKALDI_DEVICE_CACHE=mode (restoring epoch 0's checkpoints; a first
    chunk of the cache uploads the corpus), then the second under
    torch.profiler (device activity): (ChunkResult, wall, device busy s)."""
    from torch.profiler import ProfilerActivity, profile

    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    exp, plan = ft.train_plan(cfg)
    ep1 = [t for t in plan.epochs[1].tasks if t.phase == "train"]
    kw = dict(epoch_lr={a: s.lr[1] for a, s in exp.archs.items()},
              batch_size=exp.batches.batch_size_train[1])
    with _env(TPUKALDI_DEVICE_CACHE=mode):
        rt = ChunkRuntime(exp, "cuda")
        rt.run_task(ep1[0], **kw)
        chunk = rt.load_task_chunk(ep1[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # one launch ahead of the chunk, so that the trace is live
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.run_task(ep1[1], chunk=chunk, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rt.checkpointer.wait()
    busy_us, _ = _device_events(prof)
    return res, wall, busy_us / 1e6


def device_cache_phase(trees, trained, card) -> None:
    """The device-resident corpus cache (TPUKALDI_DEVICE_CACHE, auto: on
    for the card) on the flagship's tree: (a) one train chunk (seeded
    random left offsets) and one valid chunk through the cache and through
    the host path, every batch gathered on the card against the host
    batch; (b) the run at drop 0 with the cache on and off; (c) resident
    bytes, the first upload, the loader thread's seconds and a warm train
    chunk's frames/s and idle share both ways; (d) the data path each
    recipe's train and valid chunks took in its training phase."""
    from tpukaldi_torch.data.chunk_loader import ChunkData
    from tpukaldi_torch.data.device_cache import ChunkIndexData
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    recipe = "liGRU"
    tree = trees[RECIPES[recipe]["corpus"]]
    src = ft.recipe_cfg(recipe)
    out = os.path.join(WORK, "device_cache")
    os.makedirs(out)
    cfg = ft.write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                             _cuts(recipe), recipe=src)
    exp, plan = ft.train_plan(cfg)
    tasks = {p: [t for t in plan.epochs[0].tasks if t.phase == p][0]
             for p in ("train", "valid")}

    # (a) the same chunks both ways
    with _env(TPUKALDI_DEVICE_CACHE="1"):
        rt = ChunkRuntime(exp, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached = {"train": rt.load_task_chunk(tasks["train"])}
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        cached["valid"] = rt.load_task_chunk(tasks["valid"])
    with _env(TPUKALDI_DEVICE_CACHE="0"):
        rt_host = ChunkRuntime(exp, "cuda")
        host = {p: rt_host.load_task_chunk(t) for p, t in tasks.items()}
    worst, n = 0.0, {}
    for phase, task in tasks.items():
        cm, chunk = cached[phase], host[phase]
        check(isinstance(cm, ChunkIndexData) and isinstance(chunk, ChunkData),
              f"{phase}: chunks {type(cm).__name__}, {type(chunk).__name__}")
        check(cm.names == chunk.names
              and np.array_equal(cm.end_index, chunk.end_index)
              and cm.fea_layout == chunk.fea_layout,
              f"{phase}: the index chunk's metadata differs from the host's")
        train = phase == "train"
        bs = rt._effective_bs(chunk, exp.batches.batch_size_train[0] if train
                              else exp.batches.batch_size_valid)
        pairs = list(zip(rt._batches(cm, bs, train, task.seed),
                         rt_host._batches(chunk, bs, train, task.seed),
                         strict=True))
        check(len(pairs) > 0, f"{phase}: no batch")
        for c, h in pairs:
            feats, labs = rt.batch_tensors(cm, c)
            f, lab = feats.cpu().numpy(), labs.cpu().numpy()
            check(f.shape == h.feats.shape and np.allclose(
                f, h.feats, rtol=CACHE_TOL, atol=CACHE_TOL),
                f"{phase}: a gathered batch differs from the host batch "
                f"(max |diff| {np.abs(f - h.feats).max()})")
            check(np.array_equal(lab, h.labs) and c.names == h.names
                  and np.array_equal(c.lengths, h.lengths)
                  and c.n_valid_t == h.n_valid_t,
                  f"{phase}: labels, names, lengths or n_valid_t differ")
            worst = max(worst, float(np.abs(f - h.feats).max()))
        n[phase] = len(pairs)
    cache = rt.device_cache
    print(f"device cache (a) {recipe}: {n['train']} train batches (seeded "
          f"left offsets) and {n['valid']} valid batches gathered on the card "
          f"equal the host path's within rtol/atol {CACHE_TOL:g} (max |diff| "
          f"{worst:.3e}); labels, names, lengths and n_valid_t exact",
          flush=True)
    print(f"device cache (c) {recipe} on {card}: resident {cache.resident_bytes} "
          f"bytes; first chunk load (the train stream and labels read, pinned "
          f"and uploaded, then the chunk's index) {t_first:.3f} s; each "
          f"store read, pinned and enqueued: " + ", ".join(
              f"{'/'.join(map(str, key))} {nbytes} bytes {sec:.3f} s"
              for key, nbytes, sec in cache.uploads), flush=True)
    del rt, rt_host, cached, host

    # (b) the run with the cache on and off at drop 0, and the host path
    # again with its features moved by one ulp at random, a seed a run (the
    # run's own spread under a rounding change of its input)
    runs = {}
    seeds = {f"host_ulp{i}": i for i in range(RES_SPREAD_SEEDS)}
    for name, mode in (("cache", "1"), ("host", "0"),
                       *((n, "0") for n in seeds)):
        o = os.path.join(out, f"run_{name}")
        os.makedirs(o)
        c = ft.write_train_cfg(tree, o, os.path.join(o, "run.cfg"),
                               {**_cuts(recipe), **_no_drop(recipe)},
                               recipe=src)
        chunk_runtime.cache_chunks = chunk_runtime.host_chunks = 0
        nudge = (_host_features_nudged(seeds[name]) if name in seeds
                 else contextlib.nullcontext())
        with _env(TPUKALDI_DEVICE_CACHE=mode), nudge:
            t0 = time.perf_counter()
            run_experiment(c, device="cuda")
            wall = time.perf_counter() - t0
        took = (chunk_runtime.cache_chunks, chunk_runtime.host_chunks)
        check(took[0] > 0 and took[1] == 0 if mode == "1"
              else took[0] == 0 and took[1] > 0,
              f"TPUKALDI_DEVICE_CACHE={mode}: {took[0]} chunks took the "
              f"cache, {took[1]} the host path")
        vals, producer = _res_numbers(o)
        first = [t for t in ft.train_plan(c)[1].epochs[0].tasks
                 if t.phase == "train"][0]
        runs[name] = dict(cfg=c, res=np.asarray(vals), producer=producer,
                          wall=wall,
                          first=chunk_runtime.read_info(first.info_file))
    on, off = runs["cache"]["res"], runs["host"]["res"]
    check(all(r["res"].size == off.size > 0 for r in runs.values()),
          f"res.res values {[r['res'].tolist() for r in runs.values()]}")
    diff = float(np.abs(on - off).max())
    host_runs = ["host", *seeds]
    gaps = [float(np.abs(runs[a]["res"] - runs[b]["res"]).max())
            for i, a in enumerate(host_runs) for b in host_runs[i + 1:]]
    spread = max(gaps)
    first = {k: (runs["cache"]["first"][k], runs["host"]["first"][k])
             for k in ("loss", "err")}
    print(f"device cache (b) {recipe}: run_experiment at drop 0, res.res "
          f"loss and err with the cache {on.tolist()}, host path "
          f"{off.tolist()}: max |diff| {diff:.3e} (bound {RES_SPREAD_FACTOR:g}"
          f" x {spread:.3e}, the largest of the {len(gaps)} differences "
          f"{', '.join(f'{g:.3e}' for g in gaps)} between the host path and "
          f"its {len(seeds)} runs with the features moved one ulp at random: "
          + "; ".join(f"{n} {runs[n]['res'].tolist()}" for n in seeds)
          + f"); the first train chunk's .info loss and err {first} (rtol "
          f"and atol {CACHE_RUN_TOL:g}); run wall "
          f"{runs['cache']['wall']:.3f} s and {runs['host']['wall']:.3f} s; "
          f"host_load_producer per epoch {runs['cache']['producer']} s and "
          f"{runs['host']['producer']} s", flush=True)
    for k, (got, want) in first.items():
        check(math.isclose(got, want, rel_tol=CACHE_RUN_TOL,
                           abs_tol=CACHE_RUN_TOL),
              f"the first train chunk's {k} with the cache {got}, host "
              f"path {want}")
    check(diff <= RES_SPREAD_FACTOR * spread,
          f"res.res with the cache {diff} from the host path's, beyond "
          f"{RES_SPREAD_FACTOR:g} x the host path's own spread {spread}")

    # (c) a warm train chunk both ways
    for mode, label in (("1", "cache"), ("0", "host path")):
        res, wall, busy = _warm_cache_chunk(
            runs["cache" if mode == "1" else "host"]["cfg"], mode)
        print(f"device cache (c) {recipe} warm train chunk, {label}, on "
              f"{card}: {res.frames_per_sec:.1f} frames/s (.info), wall "
              f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
              f"{1 - busy / wall:.3f}; phases " + " ".join(
                  f"{k}={v:.3f}" for k, v in res.phases.items()), flush=True)

    # (d) what each recipe's training phase took
    for name, t in trained.items():
        n_cache, n_host, why = t["chunk_paths"]
        print(f"device cache (d) {name} training: {n_cache} train and valid "
              f"chunks took the cache, {n_host} the host path"
              + (f" ({why})" if n_host else ""), flush=True)


# the rate-differing phase (`rate_phase`): logMelFb, PASE and
# channel_averaging feeding the flagship's 5x550 liGRU and heads
# (`flagship_tree.write_rate_cfg`), over trees whose wave stream carries
# the TIMIT tree's utterances (150-778 label frames) as 16 kHz samples,
# 160 (n - 1) + 400 of them for logMelFb's window, 160 n for PASE's
# decimation.  name -> the front end, its window and the stream's channels
RATE_CONFIGS = {
    "logMelFb_liGRU": dict(front="logMelFb", window=400, channels=1),
    "PASE_liGRU": dict(front="PASE", window=160, channels=1),
    "chavg_logMelFb_liGRU": dict(front="chavg_logMelFb", window=400,
                                 channels=6),
}
# the two configurations trained through run_experiment; the chavg one
# runs one step check and one forward (after a one-chunk run)
RATE_TRAINED = ("logMelFb_liGRU", "PASE_liGRU")
# the trees' splits: utterances of the TIMIT tree's lengths, cut from its
# 64/16/192 to 12/4/24 (the forward runs one utterance a batch, and the
# first train chunk's twin runs on the CPU: 6 utterances, one batch of
# 199-frame pieces); the chavg tree smaller still.  The step graph trees
# hold long utterances, whose 199-frame pieces fill one bucket, so that a
# chunk forms groups of 8 (and the warm chunk's steps replay)
RATE_SPLITS = {"train": (12, 150, 778), "dev": (4, 150, 778),
               "test": (24, 150, 778)}
RATE_CHAVG_SPLITS = {"train": (8, 150, 778), "dev": (2, 150, 778),
                     "test": (4, 150, 778)}
RATE_MS_SPLITS = {"train": (48, 700, 778), "dev": (8, 700, 778),
                  "test": (2, 150, 200)}
RATE_CHAVG_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1",
                   "n_chunks = 5": "n_chunks = 1"}
RATE_MS_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 1",
                "n_chunks = 5": "n_chunks = 1"}
# (a) the front ends on the card against a float64 CPU run of the same
# module: logMelFb in log10 units on the mel bins whose float64 energy is
# at least RATE_MEL_FLOOR of its utterance's largest (below, the float32
# power spectrum's rounding dominates); PASE and channel_averaging
# relative to their largest output
RATE_LOGMEL_ATOL = 1e-3
RATE_MEL_FLOOR = 1e-8
RATE_FRONT_RTOL = 1e-4
# (b) the first train chunk's .info loss and err against a CPU twin at
# drop 0, relative and absolute (the device cache phase's rule)
RATE_TWIN_TOL = 5e-3


def _rate_cfg(tree, name, out, file, cuts, pase_json):
    from tpukaldi_torch.tools import flagship_tree as ft

    os.makedirs(out, exist_ok=True)
    return ft.write_rate_cfg(tree, out, os.path.join(out, file),
                             RATE_CONFIGS[name]["front"], cuts,
                             pase_cfg=pase_json)


def _rate_trees(pase_json):
    """name -> its tree (and `ms_<name>`: the step graph trees)."""
    from tpukaldi_torch.tools import flagship_tree as ft

    with open(pase_json, "w") as f:
        json.dump({"emb_dim": 100}, f)  # the published defaults otherwise
    trees = {}
    for name, c in RATE_CONFIGS.items():
        kinds = [(name, RATE_CHAVG_SPLITS if c["channels"] > 1
                  else RATE_SPLITS)]
        if name in RATE_TRAINED:
            kinds.append((f"ms_{name}", RATE_MS_SPLITS))
        for key, splits in kinds:
            trees[key] = ft.write_kaldi_tree(
                os.path.join(WORK, f"rate_tree_{key}"), dim=40,
                n_phones=N_PHONES, n_pdfs=N_PDFS, splits=splits,
                wave_window=c["window"], wave_channels=c["channels"])
    return trees


def _first_batch(cfg):
    """The first train batch of the cfg's first train chunk (host path)."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    exp, plan = ft.train_plan(cfg)
    task = plan.epochs[0].tasks[0]
    rt = ChunkRuntime(exp, "cpu")
    chunk = rt.load_task_chunk(task)
    bs = rt._effective_bs(chunk, exp.batches.batch_size_train[0])
    batch = next(rt._batches(chunk, bs, True, task.seed))
    return exp, torch.from_numpy(batch.feats)


def rate_front_check(cfgs) -> None:
    """(a) logMelFb, PASE (train and eval mode) and channel_averaging on
    the card at the main path's first batch against a float64 CPU run of
    the same module with the same weights."""
    from tpukaldi_torch.models import PASE, channel_averaging, logMelFb

    exp, x = _first_batch(cfgs["logMelFb_liGRU"])
    opts = exp.archs["logmel_front"].options
    got = logMelFb(opts, 1).cuda()(x.cuda()).cpu().double()
    want = logMelFb(opts, 1).double()(x.double())
    # per utterance (column b): bins within RATE_MEL_FLOOR of its largest
    # float64 energy
    top = want.amax(dim=(0, 2), keepdim=True)
    keep = want >= top + math.log10(RATE_MEL_FLOOR)
    err = float((got - want).abs()[keep].max())
    print(f"rate (a) logMelFb on the card, batch {tuple(x.shape)} -> "
          f"{tuple(got.shape)}: max |log10 diff| {err:.3e} against float64 "
          f"(bound {RATE_LOGMEL_ATOL:g}) on {int(keep.sum())} of "
          f"{keep.numel()} mel bins (energy >= {RATE_MEL_FLOOR:g} of the "
          "utterance's largest)", flush=True)
    check(err <= RATE_LOGMEL_ATOL, f"logMelFb on the card {err} from float64")

    def rel(a, b):
        return float((a.cpu().double() - b).abs().max() / b.abs().max())

    exp, x = _first_batch(cfgs["PASE_liGRU"])
    opts = exp.archs["PASE_front"].options
    card = PASE(opts, 1)
    card.reset_parameters(torch.Generator().manual_seed(3))
    ref = PASE(opts, 1).double()
    ref.load_state_dict(card.state_dict())
    card.cuda()
    errs = {}
    for mode in ("train", "eval"):
        if mode == "eval":
            # the reference's running statistics, after its train forward
            card.load_state_dict(ref.state_dict())
        card.train(mode == "train")
        ref.train(mode == "train")
        with torch.no_grad():
            errs[mode] = rel(card(x.cuda()), ref(x.double()))
    print(f"rate (a) PASE on the card (emb 100, published defaults), batch "
          f"{tuple(x.shape)}: max |diff| / max |float64| train mode "
          f"{errs['train']:.3e}, eval mode {errs['eval']:.3e} (bound "
          f"{RATE_FRONT_RTOL:g})", flush=True)
    check(max(errs.values()) <= RATE_FRONT_RTOL,
          f"PASE on the card {errs} from float64")

    exp, x = _first_batch(cfgs["chavg_logMelFb_liGRU"])
    opts = exp.archs["chavg_front"].options
    err = rel(channel_averaging(opts, 6).cuda()(x.cuda()),
              channel_averaging(opts, 6)(x.double()))
    print(f"rate (a) channel_averaging on the card, batch {tuple(x.shape)}: "
          f"max |diff| / max |float64| {err:.3e} (bound {RATE_FRONT_RTOL:g})",
          flush=True)
    check(err <= RATE_FRONT_RTOL, f"channel_averaging {err} from float64")


@contextlib.contextmanager
def _cuda_scans(calls):
    """Each call of the liGRU's plain scan on a CUDA tensor, by its ff's
    shape, while in place (under `auto` there must be none: no fallback)."""
    from tpukaldi_torch.kernels import ligru
    from tpukaldi_torch.models import recurrent

    saved = {m: m.ligru_recurrence_ref for m in (ligru, recurrent)}

    def counted(scan):
        def call(ff, *args, **kwargs):
            if ff.is_cuda:
                calls.append(tuple(ff.shape))
            return scan(ff, *args, **kwargs)
        return call

    for m, scan in saved.items():
        m.ligru_recurrence_ref = counted(scan)
    try:
        yield
    finally:
        for m, scan in saved.items():
            m.ligru_recurrence_ref = scan


def _label_frames(tree, split):
    """Utterance -> its label frames (the 40-dim stream's rows)."""
    from tpukaldi_torch.io import read_mat_scp

    return {k: m.shape[0] for k, m in read_mat_scp(
        os.path.join(tree, "data", split, "feats.scp"))}


def rate_run(modules, name, tree, cfg) -> dict:
    """(b) One rate configuration through `run_experiment(device="cuda")`,
    counted: K1f once per layer per train, valid and forward batch, K1b
    once per layer per train batch, no other kernel, no plain scan on the
    card, every train and valid chunk on the host path (rate-differing);
    the ark one finite row per label frame of each test utterance."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment
    from tpukaldi_torch.train import chunk_runtime

    out = os.path.dirname(cfg)
    scans = []
    _reset_counts(modules, chunk_runtime)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _cuda_scans(scans):
        run_experiment(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts(modules)
    _check_only(counts, "liGRU", f"{name} run")
    n_train, n_valid, n_fwd = (chunk_runtime.train_batches,
                               chunk_runtime.valid_batches,
                               chunk_runtime.forward_batches)
    fwd, bwd = counts["ligru_fwd"], counts["ligru_bwd"]
    paths = (chunk_runtime.cache_chunks, chunk_runtime.host_chunks,
             chunk_runtime.host_reason)
    steps = _graph_counts(chunk_runtime)
    infos = {f: chunk_runtime.read_info(p)
             for f, p in _train_infos(out).items()}
    check(fwd > 0 and bwd > 0 and fwd == 5 * (n_train + n_valid + n_fwd)
          and bwd == 5 * n_train,
          f"{name}: K1f {fwd}, K1b {bwd} launches for {n_train} train, "
          f"{n_valid} valid, {n_fwd} forward batches of 5 layers")
    check(not scans, f"{name}: the plain scan ran on the card: {scans[:4]}")
    check(paths[0] == 0 and paths[1] == len(infos)
          and "rate-differing" in paths[2],
          f"{name}: {paths[0]} chunks took the cache, {paths[1]} the host "
          f"path ({paths[2]!r}) of {len(infos)}")
    for f, v in infos.items():
        check(math.isfinite(v["loss"]) and math.isfinite(v["err"]),
              f"{name} {f}: {v}")
    posts, info = ft.forward_outputs(out)
    posts = dict(posts)
    want = _label_frames(tree, "test")
    check(sorted(posts) == sorted(want) and n_fwd == len(want),
          f"{name}: {len(posts)} posteriors, {n_fwd} forward batches for "
          f"{len(want)} test utterances")
    for key, post in posts.items():
        check(post.shape == (want[key], N_PDFS)
              and bool(np.isfinite(post).all()),
              f"{name} {key}: posteriors {post.shape}, {want[key]} label "
              "frames, finite " + str(bool(np.isfinite(post).all())))
    with open(os.path.join(out, "res.res")) as f:
        ep = [line.strip() for line in f if line.startswith("ep=")]
    print(f"rate (b) {name}: run_experiment on the card {wall:.3f} s, "
          f"{n_train} train + {n_valid} valid + {n_fwd} forward batches; "
          f"K1f {fwd} (= 5 x {n_train + n_valid + n_fwd}), K1b {bwd} (= 5 x "
          f"{n_train}), plain scan on the card 0; train and valid chunks: "
          f"{paths[1]} host path ({paths[2]}), {paths[0]} cache; steps "
          f"captures {steps['graph_captures']}, replays "
          f"{steps['graph_replays']}, eager {steps['eager_steps']}; ark "
          f"{len(posts)} utterances, one finite {N_PDFS}-wide row per label "
          f"frame; forward stage at batch 1 {info['frames_per_sec']:.1f} "
          f"frames/s (.info)", flush=True)
    for line in ep:
        print(f"rate (b) {name} res.res: {line}", flush=True)
    for f, v in infos.items():
        print(f"rate (b) {name} .info {f}: loss={v['loss']:.4f} "
              f"err={v['err']:.4f} {v['frames_per_sec']:.1f} samples/s, "
              f"phases {_phases(v)}", flush=True)
    return {"ligru_fwd": fwd, "ligru_bwd": bwd}


def rate_twin(name, cfgs) -> None:
    """(b) The first train chunk at drop 0 on the card and on the CPU, each
    from the cfg's seeded init: .info loss and err within RATE_TWIN_TOL."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    res = {}
    for device, cfg in cfgs.items():
        exp, plan = ft.train_plan(cfg)
        task = plan.epochs[0].tasks[0]
        rt = ChunkRuntime(exp, device)
        t0 = time.perf_counter()
        res[device] = rt.run_task(
            task, epoch_lr={a: s.lr[0] for a, s in exp.archs.items()},
            batch_size=exp.batches.batch_size_train[0])
        rt.checkpointer.wait()
        res[device].wall = time.perf_counter() - t0
    card, cpu = res["cuda"], res["cpu"]
    print(f"rate (b) {name} first train chunk at drop 0: card loss "
          f"{card.loss:.6f} err {card.err:.6f}, CPU twin loss {cpu.loss:.6f} "
          f"err {cpu.err:.6f} (rtol and atol {RATE_TWIN_TOL:g}); "
          f"{card.n_batches} steps, card {card.wall:.3f} s, CPU "
          f"{cpu.wall:.3f} s", flush=True)
    for k in ("loss", "err"):
        check(math.isclose(getattr(card, k), getattr(cpu, k),
                           rel_tol=RATE_TWIN_TOL, abs_tol=RATE_TWIN_TOL),
              f"{name}: the first train chunk's {k} on the card "
              f"{getattr(card, k)}, on the CPU {getattr(cpu, k)}")


def rate_multistep(modules, name, tree, pase_json) -> None:
    """(d) One train chunk (and its valid chunk) of long utterances, whose
    batches form groups, at TPUKALDI_MULTISTEP=1 and 8 under deterministic
    cuDNN (PASE's weight gradients): the K = 8 run's steps replay CUDA
    graphs keyed by the sample-rate T, and its .info and checkpoints must
    be the K = 1 run's bitwise."""
    runs = {}
    with _deterministic_cudnn():
        for k in (1, MS_K):
            out = os.path.join(WORK, f"rate_ms_{name}_K{k}")
            cfg = _rate_cfg(tree, name, out, "run.cfg", RATE_MS_CUTS,
                            pase_json)
            runs[k] = _ms_run(modules, cfg, k, False)
    a, g = runs[1], runs[MS_K]
    same = g["ckpts"] == a["ckpts"] and _ms_ledger(g) == _ms_ledger(a)
    n = g["train"].n_batches
    print(f"rate (d) {name} deterministic cuDNN: K1 train loss="
          f"{a['train'].loss} err={a['train'].err}, K{MS_K} loss="
          f"{g['train'].loss} err={g['train'].err}; K{MS_K}'s {n} train "
          f"steps: captures {g['train_steps']['graph_captures']}, replays "
          f"{g['train_steps']['graph_replays']}, eager "
          f"{g['train_steps']['eager_steps']}; graph pool {g['pool']} bytes; "
          f"K{MS_K} vs K1 bitwise {same} (.info and checkpoints)", flush=True)
    check(same, f"{name}: K{MS_K} differs from K1 under deterministic cuDNN")
    check(g["counts"] == a["counts"],
          f"{name}: launches at K{MS_K} {g['counts']}, at K1 {a['counts']}")
    check(g["train_steps"]["graph_captures"] >= 1
          and g["train_steps"]["graph_replays"] >= n // 2,
          f"{name}: K{MS_K} ran {g['train_steps']} of {n} train steps")


def rate_warm(name, tree, pase_json) -> None:
    """(e) The step graph tree's train chunk (24 batches, groups of 8) on a
    fresh runtime at the card's defaults, once to capture its graphs, then
    again warm under torch.profiler: samples/s (.info, tpukaldi's count:
    the padded samples), idle share, phase_dispatch, and the front end's
    device ms against the liGRU recurrence's."""
    from torch.profiler import ProfilerActivity, profile

    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

    cfg = _rate_cfg(tree, name, os.path.join(WORK, f"rate_warm_{name}"),
                    "run.cfg", RATE_MS_CUTS, pase_json)
    exp, plan = ft.train_plan(cfg)
    task = [t for t in plan.epochs[0].tasks if t.phase == "train"][0]
    kw = dict(epoch_lr={a: s.lr[0] for a, s in exp.archs.items()},
              batch_size=exp.batches.batch_size_train[0])
    rt = ChunkRuntime(exp, "cuda")
    chunk = rt.load_task_chunk(task)
    rt.run_task(task, chunk=chunk, **kw)
    rt.checkpointer.wait()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.run_task(task, chunk=chunk, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rt.checkpointer.wait()
    busy_us, per_op = _device_events(prof)
    layers = _by_layer(per_op)
    front = {k: v for k, v in layers.items() if k in RATE_FRONT_ROWS}
    rec = {k: v for k, v in layers.items() if k in RATE_LIGRU_ROWS}
    print(f"rate (e) {name} warm train chunk: {res.n_batches} steps, "
          f"{res.frames_per_sec:.1f} samples/s (.info), wall {wall:.3f} s, "
          f"device busy {busy_us / 1e6:.3f} s, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}, phase_dispatch "
          f"{res.phases['dispatch']:.3f} s; front end "
          f"{sum(front.values()) / 1e3:.3f} ms ("
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in front.items())
          + f"), liGRU recurrence {sum(rec.values()) / 1e3:.3f} ms ("
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in rec.items()) + ")",
          flush=True)
    for layer, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"rate (e) {name} warm train chunk layer: {layer}: "
              f"{us / 1e3:.3f} ms ({us / busy_us:.1%} of busy)", flush=True)


def rate_bf16_refusal(tree, name, pase_json) -> None:
    """(f) In bf16 compute mode, logMelFb and PASE raise NotImplementedError
    (the class and the dtype named) before any output is written: the out
    folder is never made."""
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.run_exp import run_experiment

    out = os.path.join(WORK, f"rate_bf16_{name}")
    cfg = ft.write_rate_cfg(tree, out, out + ".cfg",
                            RATE_CONFIGS[name]["front"], TRAIN_CUTS,
                            pase_cfg=pase_json)
    cls = "PASE" if name.startswith("PASE") else "logMelFb"
    try:
        with _env(TPUKALDI_COMPUTE_DTYPE="bfloat16"):
            run_experiment(cfg, device="cuda")
    except NotImplementedError as e:
        msg = str(e)
    else:
        msg = ""
    check(cls in msg and "bfloat16" in msg and not os.path.exists(out),
          f"{name} in bf16: {msg!r}, out folder made {os.path.exists(out)}")
    print(f"rate (f) {name} at TPUKALDI_COMPUTE_DTYPE=bfloat16: "
          f"NotImplementedError before any output ({msg})", flush=True)


def rate_phase(modules, card) -> dict:
    """The rate-differing raw-wave path on the card: (a) the front ends
    against float64; (b) logMelFb_liGRU and PASE_liGRU trained (2 epochs
    of 2 chunks) and served through run_experiment, counted, their first
    train chunk against a CPU twin at drop 0, and chavg_logMelFb_liGRU for
    one chunk and its forward; (c) a train step of each held to float64;
    (d) a chunk at K = 8 bitwise K = 1; (e) a warm chunk's speed; (f) the
    bf16 refusal.  Returns K1's launches on the three runs."""
    pase_json = os.path.join(WORK, "pase.json")
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    trees = _rate_trees(pase_json)
    print(f"rate trees: {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    cfgs, twins, steps = {}, {}, {}
    for name in RATE_CONFIGS:
        cuts = RATE_CHAVG_CUTS if name not in RATE_TRAINED else TRAIN_CUTS
        cfgs[name] = _rate_cfg(trees[name], name,
                               os.path.join(WORK, f"rate_{name}"), "run.cfg",
                               cuts, pase_json)
        nd = {**TRAIN_CUTS, **_no_drop("liGRU")}
        steps[name] = [_rate_cfg(trees[name], name,
                                 os.path.join(WORK, f"rate_{name}_step"),
                                 f"{p}.cfg", {**nd, **extra}, pase_json)
                       for p, extra in (("k", {}), ("s", _scan("liGRU")))]
        twins[name] = {dev: _rate_cfg(trees[name], name,
                                      os.path.join(WORK, f"rate_{name}_{dev}"),
                                      "run.cfg", nd, pase_json)
                       for dev in ("cuda", "cpu")}
    _timed("rate (a) front ends", rate_front_check, cfgs)
    launches = {"ligru_fwd": 0, "ligru_bwd": 0}
    for name in RATE_CONFIGS:
        r = _timed(f"rate (b) {name}", rate_run, modules, name, trees[name],
                   cfgs[name])
        for k in launches:
            launches[k] += r[k]
        if name in RATE_TRAINED:
            _timed(f"rate (b) {name} twin", rate_twin, name, twins[name])
    for name in RATE_CONFIGS:
        # PASE's conv biases sit before its batchnorms, and its last
        # batchnorm's shift before the liGRU's
        _timed(f"rate (c) {name} step", held_step, modules, "liGRU", name,
               *steps[name], r"PASE_front\.(conv\.\d+|emb|emb_bn)\.bias")
    for name in RATE_TRAINED:
        _timed(f"rate (d) {name} step graphs", rate_multistep, modules, name,
               trees[f"ms_{name}"], pase_json)
        _timed(f"rate (e) {name} warm chunk", rate_warm, name,
               trees[f"ms_{name}"], pase_json)
        rate_bf16_refusal(trees[name], name, pase_json)
    return launches


# the dist_export phase: data parallelism and the serving export on the
# flagship (5x550 bidirectional liGRU, batch 8) over the multistep phase's
# TIMIT tree, whose train chunk's batches form groups of 8
DIST_RECIPE = "liGRU"
# (b)'s two ranks against the one-process step: loss and err
DIST_LOSS_ATOL = 1e-5
# (c) the artifact against the live forward: on the card, and on the CPU
# (over DIST_CPU_UTTS utterances) against the plain path
DIST_FWD_ATOL = 1e-5
DIST_CPU_ATOL = 1e-4
DIST_CPU_UTTS = 2
DIST_RANKS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dist_cfg(trees, name, no_drop=False, replace=None):
    """The flagship at full width over the multistep TIMIT tree, one train
    chunk a epoch, in a folder of its own."""
    from tpukaldi_torch.tools import flagship_tree as ft

    out = os.path.join(WORK, f"dist_{name}")
    os.makedirs(out)
    cuts = {**_cuts(DIST_RECIPE), "n_chunks = 5": "n_chunks = 1",
            **(_no_drop(DIST_RECIPE) if no_drop else {}), **(replace or {})}
    return ft.write_train_cfg(trees["MS_TIMIT"], out,
                              os.path.join(out, "run.cfg"), cuts,
                              recipe=ft.recipe_cfg(DIST_RECIPE)), out


def dist_nccl_check(modules, trees) -> dict:
    """(a) One train chunk and one valid chunk at K = MS_K, without a
    process group and in an NCCL group of one rank (its gradient and loss
    all-reduces captured in the step graphs): the `.info` loss and err and
    the checkpoints bitwise the same.  Returns the NCCL run's cfg (its
    train checkpoints copied to the final ones) and kernel counts."""
    from tpukaldi_torch import dist
    from tpukaldi_torch.tools import flagship_tree as ft

    runs, cfgs = {}, {}
    for name in ("one", "nccl1"):
        cfgs[name], _ = _dist_cfg(trees, name)
        mesh = None
        if name == "nccl1":
            dist.init_distributed(f"localhost:{_free_port()}", 1, 0,
                                  device="cuda:0")
            mesh = dist.data_parallel_mesh("cuda:0")
            check(mesh.backend == "nccl" and mesh.world_size == 1,
                  f"the NCCL group: {mesh}")
        try:
            runs[name] = _ms_run(modules, cfgs[name], MS_K, False, mesh)
        finally:
            if mesh is not None:
                torch.distributed.destroy_process_group()
    one, nccl = runs["one"], runs["nccl1"]
    for name, run in runs.items():
        print(f"dist (a) {name}: train loss={run['train'].loss} "
              f"err={run['train'].err}, valid loss={run['valid'].loss} "
              f"err={run['valid'].err} (.info); train steps: captures "
              f"{run['train_steps']['graph_captures']}, replays "
              f"{run['train_steps']['graph_replays']}, eager "
              f"{run['train_steps']['eager_steps']}; "
              f"{run['train'].frames_per_sec:.1f} frames/s (.info), wall "
              f"{run['wall']:.3f} s", flush=True)
    same = nccl["ckpts"] == one["ckpts"] and _ms_ledger(nccl) == _ms_ledger(one)
    print(f"dist (a) NCCL world size 1 vs no group: .info and checkpoints "
          f"bitwise {same}; launches {nccl['counts']['ligru_fwd']} K1f, "
          f"{nccl['counts']['ligru_bwd']} K1b", flush=True)
    check(same, "NCCL at world size 1 differs from the run without a group")
    check(nccl["counts"] == one["counts"],
          f"launches {nccl['counts']} under NCCL, {one['counts']} without")
    check(nccl["train_steps"]["graph_captures"] >= 1
          and nccl["train_steps"]["graph_replays"] >= 1,
          f"no step graph held NCCL's all-reduce: {nccl['train_steps']}")
    _, plan = ft.train_plan(cfgs["nccl1"])
    train = [t for t in plan.epochs[0].tasks if t.phase == "train"][0]
    for arch, final in plan.final_ckpts.items():
        shutil.copyfile(train.ckpt_files[arch], final)
    return {"cfg": cfgs["nccl1"], "counts": nccl["counts"]}


def _watch_writes(folder: str, seen: list) -> None:
    """Record every open for writing, and every rename, of a file under
    `folder`."""
    import builtins

    folder = os.path.abspath(folder)
    real_open, real_replace = builtins.open, os.replace

    def under(path):
        return (isinstance(path, (str, os.PathLike))
                and os.path.abspath(path).startswith(folder))

    def spy_open(file, mode="r", *args, **kwargs):
        if under(file) and any(c in mode for c in "wax+"):
            seen.append(os.fspath(file))
        return real_open(file, mode, *args, **kwargs)

    def spy_replace(src, dst, *args, **kwargs):
        if under(dst):
            seen.append(os.fspath(dst))
        return real_replace(src, dst, *args, **kwargs)

    builtins.open, os.replace = spy_open, spy_replace


def _first_step(cfg, mesh=None, rank=0):
    """One train step of the cfg's seeded init on the first batch of its
    first train chunk (the host path), this rank's shard of it under
    `mesh`, with K1b's relu decisions recorded: loss, err, the shard's and
    the batch's shapes, the shard's weight, K1f's and K1b's launches, the
    relu decisions, the gradients and the stepped state, on the host."""
    from tpukaldi_torch.kernels import ligru
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime
    from tpukaldi_torch.train.step import train_step

    exp, plan = ft.train_plan(cfg)
    task = plan.epochs[0].tasks[0]
    with _env(TPUKALDI_DEVICE_CACHE="0"):
        rt = chunk_runtime.ChunkRuntime(exp, "cuda", mesh)
        chunk = rt.load_task_chunk(task)
    rt.ensure_initialized(chunk, with_optimizers=True)
    bs = rt._effective_bs(chunk, exp.batches.batch_size_train[0])
    batch = next(rt._batches(chunk, bs, True, task.seed))
    feats, labs, weight = rt.shard(torch.from_numpy(batch.feats),
                                   torch.from_numpy(batch.labs))
    n0 = (ligru.launches, ligru.bwd_launches)
    relu = []
    rt.generator.manual_seed(chunk_runtime.batch_seed(task.seed, 0, rank))
    with _k1b_relu(relu):
        loss, err = train_step(
            rt.graph, rt.optimizers, feats.contiguous().cuda(),
            labs.contiguous().cuda(), batch.n_valid_t, rt.generator,
            rt.compute_dtype, mesh, weight)
    return dict(
        loss=loss.item(), err=err.item(), weight=weight,
        shard=tuple(feats.shape), batch=tuple(batch.feats.shape),
        step_launches=(ligru.launches - n0[0], ligru.bwd_launches - n0[1]),
        relu=[r.cpu() for r in relu],
        grads={f"{a}.{n}": p.grad.detach().cpu()
               for a, m in rt.graph.modules.items()
               for n, p in m.named_parameters()},
        params={f"{a}.{n}": v.detach().cpu()
                for a, m in rt.graph.modules.items()
                for n, v in m.state_dict().items()})


def _dist_rank(rank, port, cfg_step, cfg_run, out_run, results):
    """(b) One of two ranks of a gloo group on the one card: one train step
    of the flagship's first batch (its shard of the 8 columns) with K1b's
    relu decisions recorded, then the first train chunk of `cfg_run`
    through `run_task`, rank 1 watched for writes under `out_run`.  Puts
    its results on `results`."""
    sys.path.insert(0, REPO)
    os.environ.update(TPUKALDI_DEVICE_CACHE="0", TPUKALDI_MULTISTEP="1")
    from tpukaldi_torch import dist
    from tpukaldi_torch.kernels import ligru
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train import chunk_runtime

    torch.cuda.set_device(0)
    dist.init_distributed(f"localhost:{port}", DIST_RANKS, rank,
                          device="cuda:0", backend="gloo")
    mesh = dist.data_parallel_mesh("cuda:0")
    out = {"rank": rank, "mesh": repr(mesh)}
    try:
        out.update(_first_step(cfg_step, mesh, rank))
        # the first train chunk of a run's folder: only rank 0 writes
        writes = []
        if rank != 0:
            _watch_writes(out_run, writes)
        exp, plan = ft.train_plan(cfg_run)
        task = plan.epochs[0].tasks[0]
        rt = chunk_runtime.ChunkRuntime(exp, "cuda", mesh)
        ligru.launches = ligru.bwd_launches = 0
        chunk_runtime.train_batches = 0
        res = rt.run_task(
            task, epoch_lr={a: s.lr[0] for a, s in exp.archs.items()},
            batch_size=exp.batches.batch_size_train[0])
        rt.checkpointer.wait()
        out.update(chunk_loss=res.loss, chunk_err=res.err,
                   chunk_batches=chunk_runtime.train_batches,
                   chunk_launches=(ligru.launches, ligru.bwd_launches),
                   writes=writes, info=task.info_file,
                   ckpts=sorted(task.ckpt_files.values()))
    finally:
        torch.distributed.destroy_process_group()
        # by value: torch's own pickling shares a tensor's storage through
        # this process, which exits
        results.put(_tree_map(lambda t: t.numpy(), out))


def _tree_map(fn, tree):
    """fn over every tensor (or numpy array) of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _assemble_relu(ranks, B):
    """The ranks' K1b relu decisions, a (T, 2 x shard, H) tensor a layer on
    each, as the one-process layout (T, 2B, H): rank r's forward columns
    and its reversed copies at their places in the doubled batch."""
    from tpukaldi_torch.dist import DataParallelMesh, shard_bounds

    layers = []
    for i in range(len(ranks[0]["relu"])):
        rec0 = ranks[0]["relu"][i]
        full = torch.zeros((rec0.shape[0], 2 * B, rec0.shape[2]),
                           dtype=rec0.dtype)
        for rank, r in enumerate(ranks):
            lo, hi = shard_bounds(B, DataParallelMesh(
                rank, len(ranks), rank, torch.device("cpu"), "gloo"))
            n = hi - lo
            full[:, lo:hi] = r["relu"][i][:, :n]
            full[:, B + lo:B + hi] = r["relu"][i][:, n:]
        layers.append(full.cuda())
    return layers


def _worst(grads, ref):
    """(max over tensors of max|g - ref| / max|ref|, that tensor)."""
    rel = {name: ((g.double().cpu() - ref[name].double().cpu()).abs().max()
                  / ref[name].double().abs().max().clamp_min(1e-30)).item()
           for name, g in grads.items()}
    check(all(math.isfinite(r) for r in rel.values()),
          "non-finite gradient error")
    name = max(rel, key=rel.get)
    return rel[name], name


def dist_gloo_check(modules, trees) -> dict:
    """(b) Two ranks of a gloo group on the one card, eager (gloo's
    collectives do not capture): one train step of the flagship's first
    batch at drop 0, its 8 columns split 4/4, against the one-process step
    on the same batch (both from the host path): loss and err within
    DIST_LOSS_ATOL; the summed gradients held to a float64 step within
    STEP_GRAD_FACTOR of the plain path's distance, each path's float64 run
    taking the path's own relu decisions at its near ties (`held_step`'s
    rule); both ranks' gradients and weights bitwise the same; each rank's
    K1f and K1b launches counted; then each rank trains the first train
    chunk of a run, and rank 1 writes no file of the run's folder."""
    import multiprocessing

    from tpukaldi_torch.tools import flagship_tree as ft

    cfg_k, out_k = _dist_cfg(trees, "step", no_drop=True)
    cfg_s = ft.write_train_cfg(
        trees["MS_TIMIT"], out_k, os.path.join(out_k, "s.cfg"),
        {**_cuts(DIST_RECIPE), "n_chunks = 5": "n_chunks = 1",
         **_no_drop(DIST_RECIPE), **_scan(DIST_RECIPE)},
        recipe=ft.recipe_cfg(DIST_RECIPE))
    # the train set in 4 chunks: 4 steps of 8 columns a chunk
    cfg_run, out_run = _dist_cfg(trees, "gloo_run",
                                 replace={"n_chunks = 5": "n_chunks = 4"})
    ctx = multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, port, cfg_k, cfg_run, out_run, results))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    got = [results.get() for _ in procs]
    for p in procs:
        p.join(timeout=120)
        check(p.exitcode == 0, f"a gloo rank exited with {p.exitcode}")
    ranks = sorted((_tree_map(torch.from_numpy, r) for r in got),
                   key=lambda r: r["rank"])
    wall = time.perf_counter() - t0
    check(all("loss" in r and "writes" in r for r in ranks),
          f"a gloo rank failed: {[sorted(r) for r in ranks]}")

    # the one-process paths on the same host batch
    one = _first_step(cfg_k)
    loss_1, grads_1, relu_1 = one["loss"], one["grads"], one["relu"]
    shape = one["batch"]
    relu_1 = [r.cuda() for r in relu_1]
    with _env(TPUKALDI_DEVICE_CACHE="0"):
        a_s, a_r, g_r = [], [], []
        with _scan_relu(record=a_s):
            loss_s, grads_s, _ = ft.train_step_gradients(cfg_s, "cuda")
        with _scan_relu(record=a_r, grads=g_r):
            loss_r, grads_r, _ = ft.train_step_gradients(cfg_s, "cuda",
                                                         torch.float64)
        B = shape[1]
        check(ranks[0]["batch"] == shape, f"the ranks' batch "
              f"{ranks[0]['batch']}, the one-process batch {shape}")
        relu_2 = _assemble_relu(ranks, B)
        errs, ties = {}, {}
        for path, pos, grads in (
                ("two ranks", relu_2, ranks[0]["grads"]),
                ("one process", relu_1, grads_1),
                ("plain", [a > 0 for a in a_s], grads_s)):
            decide, ties[path] = _relu_ties("dist", path, pos, a_r, g_r, a_s)
            ref = grads_r
            if ties[path]:
                with _scan_relu(decide=decide):
                    _, ref, _ = ft.train_step_gradients(cfg_s, "cuda",
                                                        torch.float64)
            errs[path] = _worst(grads, ref)
    r0, r1 = ranks
    loss_err = abs(r0["loss"] - loss_1)
    err_err = abs(r0["err"] - one["err"])
    step_diff = max(float((r0["params"][n].double()
                           - one["params"][n].double()).abs().max())
                    for n in one["params"] if one["params"][n].is_floating_point())
    same_ranks = (all(torch.equal(r0["grads"][n], r1["grads"][n])
                      for n in r0["grads"])
                  and all(torch.equal(r0["params"][n], r1["params"][n])
                          for n in r0["params"]))
    print(f"dist (b) gloo, {DIST_RANKS} ranks on {torch.cuda.get_device_name(0)}"
          f" (spawned, {wall:.1f} s with their start): batch {shape} split "
          f"{[r['shard'] for r in ranks]}, weights "
          f"{[r['weight'] for r in ranks]}; loss two ranks {r0['loss']:.7f} "
          f"one process {loss_1:.7f} plain {loss_s:.7f} float64 "
          f"{loss_r:.7f}, |two - one| {loss_err:.3e} (atol "
          f"{DIST_LOSS_ATOL:g}); err two ranks {r0['err']:.7f} one process "
          f"{one['err']:.7f}, |diff| {err_err:.3e}; weights after the step "
          f"max|two - one| {step_diff:.3e} (rmsprop's first step takes "
          f"lr x sign(g) where |g| >> eps); worst gradient error vs float64 (each "
          f"path's own relu decisions at its ties): "
          + ", ".join(f"{p} {e:.3e} ({n}, {len(ties[p])} ties)"
                      for p, (e, n) in errs.items())
          + f" (factor {STEP_GRAD_FACTOR:g} of the plain path's); ranks' "
          f"gradients and weights bitwise equal {same_ranks}; step launches "
          f"K1f/K1b by rank {[r['step_launches'] for r in ranks]}", flush=True)
    for r in ranks:
        print(f"dist (b) rank {r['rank']} train chunk: loss={r['chunk_loss']}"
              f" err={r['chunk_err']}, {r['chunk_batches']} steps, K1f/K1b "
              f"{r['chunk_launches']}, files written under the run "
              f"{len(r['writes'])}", flush=True)
    check(loss_err <= DIST_LOSS_ATOL and err_err <= DIST_LOSS_ATOL,
          f"two-rank loss, err {r0['loss']}, {r0['err']} vs {loss_1}, "
          f"{one['err']}")
    check(errs["two ranks"][0] <= STEP_GRAD_FACTOR * errs["plain"][0],
          f"two-rank gradients {errs['two ranks']} from float64, plain path "
          f"{errs['plain']}")
    check(same_ranks, "the ranks' gradients or weights differ")
    layers = RECIPES[DIST_RECIPE]["layers"]
    for r in ranks:
        check(r["step_launches"] == (layers, layers),
              f"rank {r['rank']}: K1f/K1b {r['step_launches']} in one step")
        n = r["chunk_batches"]
        check(n > 0 and r["chunk_launches"] == (layers * n, layers * n),
              f"rank {r['rank']}: K1f/K1b {r['chunk_launches']} in {n} steps")
    check(r0["chunk_loss"] == r1["chunk_loss"],
          "the ranks' chunk losses differ")
    check(not r1["writes"], f"rank 1 wrote {r1['writes']}")
    check(os.path.exists(r0["info"]) and all(
        os.path.exists(p) for p in r0["ckpts"]),
          "rank 0 wrote no .info or checkpoint")
    check(r0["err"] == r1["err"], "the ranks' err differ")
    return {"ligru_fwd": [r["step_launches"][0] + r["chunk_launches"][0]
                          for r in ranks],
            "ligru_bwd": [r["step_launches"][1] + r["chunk_launches"][1]
                          for r in ranks]}


def export_check(modules, cfg, label, layers) -> int:
    """A trained experiment exported at symbolic T and B
    (`tools/export_model.py`), loaded on the card and served over the test
    split at batch 8: posteriors within DIST_FWD_ATOL of the live
    `forward_step`, K1f launched by the artifact `layers` times a batch
    (counted) and no other hand kernel (none at all where `layers` is 0);
    the same artifact on the CPU over DIST_CPU_UTTS utterances within
    DIST_CPU_ATOL of the CPU plain path.  Returns the artifact's K1f
    launches."""
    from tpukaldi_torch.data.batching import iter_forward_batches
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.tools.export_model import export_forward, load_exported
    from tpukaldi_torch.train import chunk_runtime
    from tpukaldi_torch.train.step import forward_step

    art = os.path.join(WORK, re.sub(r"\W+", "_", label) + "_artifact")
    t0 = time.perf_counter()
    export_forward(cfg, art)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = load_exported(art)
    t_load = time.perf_counter() - t0
    check(card.meta["batch"] == 0, f"{label}: artifact batch "
          f"{card.meta['batch']}")
    exp, plan = ft.train_plan(cfg)
    task = plan.forward_tasks[0]
    rts = {}
    for device in ("cuda", "cpu"):
        rt = chunk_runtime.ChunkRuntime(exp, device)
        chunk = rt.load_task_chunk(task)
        rt.ensure_initialized(chunk)
        rt.restore_from(task.pretrain_files, every_rank=False)
        rts[device] = rt
    worst, n_batches, frames = 0.0, 0, 0
    launched = dict.fromkeys(KERNELS, 0)
    serve_s = live_s = 0.0
    for batch in iter_forward_batches(chunk, 8):
        feats = torch.from_numpy(batch.feats).cuda()
        lengths = torch.from_numpy(batch.lengths.astype(np.int32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = forward_step(rts["cuda"].graph, feats, lengths)
        torch.cuda.synchronize()
        live_s += time.perf_counter() - t0
        before = _counts(modules)
        t0 = time.perf_counter()
        served = card.call(feats, lengths)
        torch.cuda.synchronize()
        serve_s += time.perf_counter() - t0
        for name, n in _counts(modules).items():
            launched[name] += n - before[name]
        n_batches += 1
        frames += int(batch.lengths.sum())
        check(set(served) == set(live), f"{label}: outputs {sorted(served)} "
              f"vs {sorted(live)}")
        for k, v in served.items():
            check(bool(torch.isfinite(v).all()), f"{label} {k}: non-finite")
            worst = max(worst, float((v - live[k]).abs().max()))
    launches = launched.pop("ligru_fwd")
    # the CPU: the artifact and the plain path on the shortest and longest
    # utterances, each alone
    cpu = load_exported(art, device="cpu")
    starts = [0, *chunk.end_index[:-1]]
    lens = [int(e) - int(s) for s, e in zip(starts, chunk.end_index)]
    picks = sorted({lens.index(min(lens)), lens.index(max(lens))})
    worst_cpu = 0.0
    for i in picks[:DIST_CPU_UTTS]:
        x = torch.from_numpy(
            chunk.feats[int(starts[i]):int(chunk.end_index[i])])[:, None, :]
        n = torch.tensor([x.shape[0]], dtype=torch.int32)
        want = forward_step(rts["cpu"].graph, x, n)
        got = cpu.call(x, n)
        for k in want:
            worst_cpu = max(worst_cpu, float((got[k] - want[k]).abs().max()))
    print(f"{label}: {t_export:.1f} s to export, {t_load:.1f} s to "
          f"load on the card (meta: batch {card.meta['batch']}, platforms "
          f"{card.meta['platforms']}, {card.meta['compute_dtype']}); the "
          f"test split, {n_batches} batches of up to 8 ({frames} frames): "
          f"artifact {serve_s * 1e3:.1f} ms, live forward_step "
          f"{live_s * 1e3:.1f} ms, max|artifact - live| {worst:.3e} (atol "
          f"{DIST_FWD_ATOL:g}); K1f launched by the artifact {launches} "
          f"(= {layers} x {n_batches}); on the CPU, {len(picks)} utterances "
          f"of {[lens[i] for i in picks]} frames, max|artifact - plain path| "
          f"{worst_cpu:.3e} (atol {DIST_CPU_ATOL:g})", flush=True)
    check(worst <= DIST_FWD_ATOL, f"{label}: artifact vs live forward {worst}")
    check(launches == layers * n_batches,
          f"{label}: the artifact launched K1f {launches} times, expected "
          f"{layers} x {n_batches}")
    others = {k: n for k, n in launched.items() if n}
    check(not others, f"{label}: the artifact launched {others}")
    check(worst_cpu <= DIST_CPU_ATOL, f"{label}: CPU artifact vs plain "
          f"{worst_cpu}")
    return launches


def dist_export_phase(modules, trees) -> dict:
    """The data-parallel mesh and the serving export on the flagship: (a)
    `dist_nccl_check`, (b) `dist_gloo_check`, (c) `export_check`.
    Returns the kernels line's extra counts for K1f and K1b."""
    a = _timed("dist (a) NCCL world size 1", dist_nccl_check, modules, trees)
    b = _timed("dist (b) gloo two ranks", dist_gloo_check, modules, trees)
    c = _timed("dist (c) export", export_check, modules, a["cfg"],
               "dist (c) export", RECIPES[DIST_RECIPE]["layers"])
    return {
        "ligru_fwd": {"dist_launches": {"nccl_world_1": a["counts"]["ligru_fwd"],
                                        "gloo_ranks": b["ligru_fwd"]},
                      "export_launches": c},
        "ligru_bwd": {"dist_launches": {"nccl_world_1": a["counts"]["ligru_bwd"],
                                        "gloo_ranks": b["ligru_bwd"]}},
    }


def build_kernels(modules) -> None:
    """Every kernel source, and the L2 probe's (`measure_l2`), one nvcc
    each, all at once."""
    from tpukaldi_torch.kernels import _build

    t0 = time.perf_counter()
    sources = [getattr(modules[mod], attr)
               for mod, _, attr, _ in KERNELS.values()] + ["l2_read.cu"]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"build {', '.join(sources)} (nvcc sm_90a, in parallel): "
          f"{time.perf_counter() - t0:.2f} s -> "
          + ", ".join(os.path.relpath(lib, REPO) for lib in libs), flush=True)
    for source, lib in zip(sources, libs):
        for kernel, regs, spill in _ptxas(f"{lib}.txt"):
            print(f"ptxas {source} {kernel}: {regs} registers, {spill}",
                  flush=True)


def _ptxas(report):
    """(kernel, registers, spills) of each kernel in a ptxas -v report."""
    with open(report) as f:
        text = f.read()
    found = []
    for part in text.split("Compiling entry function")[1:]:
        name = re.search(r"([a-z_]+_kernel)", part)
        taps = re.match(r"[^\n]*?_kernelILi(\d+)E", part)  # a template's K
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        check(bool(name and regs and spill), f"unreadable ptxas report {report}")
        found.append((name.group(1) + (f"<{taps.group(1)}>" if taps else ""),
                      regs.group(1),
                      f"{spill.group(1)} bytes spill stores, "
                      f"{spill.group(2)} bytes spill loads"))
    check(bool(found), f"no kernel in the ptxas report {report}")
    return found


def _wide_extra(name, k) -> dict:
    """A forward recurrence's numbers at WIDE_FWD_SHAPES[0] (H = 2048, its
    U streamed) for its record on the kernels line."""
    T, B, H = WIDE_FWD_SHAPES[0]
    ms, plain_ms = k["timing"][(name, T, B, H)]
    bound, bound_by = bound_ms(name, T, B, H)
    lib = k["library_wide"].get(name)
    return {"h2048_shape": [T, B, H], "h2048_ms": ms,
            "h2048_plain_ms": plain_ms, "h2048_bound_ms": bound,
            "h2048_bound_by": bound_by, "h2048_l2_bytes": L2["bytes"],
            "h2048_l2_read_bytes_per_s": L2["rate"],
            "h2048_library_ms": None if lib is None else lib[0]}


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
    from tpukaldi_torch.kernels import conv1d, conv_stack, gru, ligru, lstm
    from tpukaldi_torch.tools import flagship_tree as ft
    from tpukaldi_torch.train.chunk_runtime import resolve_device

    # the port's own entry pins float32 arithmetic (cuDNN's TF32 off) when
    # it resolves the card: the kernel phase's plain versions run under it
    resolve_device("cuda")
    print(f"precision (the port's setting): cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    modules = {"ligru": ligru, "lstm": lstm, "gru": gru, "conv1d": conv1d,
               "conv_stack": conv_stack}
    build_kernels(modules)
    measure_l2()

    # a process's first torch.optim optimizer imports torch._dynamo (seconds
    # of host time, once per process); done here, timed, so that no chunk
    # measured below carries it
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    print(f"import torch._dynamo (once per training process): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    k = _timed("kernels", kernel_phase,
               {"ligru": ligru, "lstm": lstm, "gru": gru, "lstm_lean": lstm})
    conv = _timed("conv kernels", conv_kernel_phase, conv1d)
    stack = _timed("conv stack kernels and path", stack_phase, modules)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    # the raw tree is in TIMIT's layout, with the raw stream beside its
    # 40-dim one
    trees = {corpus: ft.write_kaldi_tree(
        os.path.join(WORK, corpus.lower()), dim=40, n_phones=N_PHONES,
        n_pdfs=N_PDFS, splits=t["splits"],
        corpus="DIRHA" if corpus == "DIRHA" else "TIMIT",
        raw_wlen=t["dim"] if corpus == "RAW" else None)
        for corpus, t in TREES.items()}
    print(f"synthetic trees: {time.perf_counter() - t0:.1f} s", flush=True)
    trained = {}
    # the stack kernels' launches on every recipe path (each checked 0 by
    # `_check_only`, as no recipe calls the stack)
    recipe_stack = dict.fromkeys(STACK_KERNELS, 0)
    for recipe in RECIPES:
        s = _timed(f"{recipe} serving", serving_phase, modules, trees, recipe)
        trained[recipe] = _timed(f"{recipe} training", train_phase, modules,
                                 trees, recipe)
        _timed(f"{recipe} profile", profile_phase, recipe, s["cfg"],
               trained[recipe]["cfg"])
        for name in STACK_KERNELS:
            recipe_stack[name] += (s["stack_launches"][name]
                                   + trained[recipe]["stack_launches"][name])
    wide = _timed("liGRU-2048 serving and refusals", wide_phase, modules,
                  trees)
    sinc251 = _timed("SincNet-251", sinc251_phase, modules, trees)
    _timed("device cache", device_cache_phase, trees, trained, card)
    trees = _timed("multistep", multistep_all, modules, trees)
    bf16 = _timed("bf16", bf16_phase, modules, trees)
    fusion = _timed("zoo", zoo_phase, modules, trees)
    rate = _timed("rate", rate_phase, modules, card)
    dist_extra = _timed("dist export", dist_export_phase, modules, trees)
    print(f"chip_smoke total (after the card check): "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, rec, launches, **extra):
        """A kernel's record on the kernels line."""
        mod, _, attr, replaces = KERNELS[name]
        return {"name": name, "route": "cuda",
                "source": "tpukaldi_torch/kernels/csrc/"
                          + getattr(modules[mod], attr),
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": rec["err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}

    kernels = []
    for recipe, r in RECIPES.items():
        lean = recipe == "QLSTM"
        for kind, shapes, key in (
                ("fwd", LEAN_FWD_SHAPES if lean else FWD_SHAPES, "launches"),
                ("bwd", LEAN_BWD_SHAPES if lean else BWD_SHAPES,
                 "bwd_launches")):
            name = r[kind]
            if _raw(recipe):
                rec = conv[name]
            else:
                T, B, H = shapes[0]
                ms, plain_ms = k["timing"][(name, T, B, H)]
                bound, bound_by = bound_ms(name, T, B, H)
                lib = k["library"].get(name)
                check(lib is None or lib[1:] == (T, B, H),
                      f"{name}: library timed at {lib}, the kernel at "
                      f"{(T, B, H)}")
                rec = dict(err=k["errs"][name], ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=None if lib is None else lib[0])
            # K1's launches on the fusion path beside the flagship's
            extra = dict(fusion.get(name, {}))
            if kind == "fwd" and not _raw(recipe):
                extra.update(_wide_extra(name, k))
            if name in wide:
                extra["flagship2048_launches"] = wide[name]
            if name in rate:
                extra["rate_launches"] = rate[name]
            extra.update(dist_extra.get(name, {}))
            extra.update(_bf16_extra(name, bf16))
            if _raw(recipe):
                # the times at SincNet's 251 taps, and K5's launches on its
                # run
                extra.update({k: v for k, v in rec.items()
                              if k.startswith("k251_")})
                if name in sinc251:
                    extra["sinc251_launches"] = sinc251[name]
            kernels.append(entry(name, rec, trained[recipe][key], **extra))
    # the stack's kernels: launches on its own path, and on the recipe paths
    kernels += [entry(name, stack[name], stack[name]["launches"],
                      recipe_launches=recipe_stack[name])
                for name in STACK_KERNELS]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
