"""Synthetic Kaldi trees in real formats, and the recipe cfgs pointed at
them: the TIMIT fMLLR recipes (the flagship `cfg/TIMIT/liGRU_fmllr.cfg` by
default, or `recipe_cfg("LSTM")`, `recipe_cfg("GRU")`) and the TIMIT
raw-waveform recipes (`recipe_cfg("CNN")`, `cfg/TIMIT/CNN_raw.cfg`, and
`recipe_cfg("SincNet")`, `SincNet_raw.cfg`) over a TIMIT tree, and the
DIRHA QLSTM recipe (`recipe_cfg("QLSTM")`, `cfg/DIRHA/QLSTM_mfcc.cfg`) over
a DIRHA tree (`write_kaldi_tree(..., corpus="DIRHA")`), for training
(`write_train_cfg`) or production forward (`write_prod_cfg`) — inputs for
running the port end to end without a corpus (`chip_smoke.py`, the tests)
— and helpers to set up and check such a run: seeded initial or final
checkpoints, the forward outputs, and a second forward of chosen
utterances.

A tree carries what those cfgs read: per split a `feats.ark/.scp` (aliased
as the mfcc/fbank/fmllr/mfcc_6ch streams), `utt2spk`, per-speaker CMVN stats per
stream, and alignments, gzipped transition-id archives beside a binary
`final.mdl`, so `N_out_lab_cd`/`N_out_lab_mono` and the prior counts
resolve natively (hmm-info, ali-to-pdf, analyze-counts).  TIMIT keeps one
alignment dir per split, DIRHA one for all three.  Features are
pdf-conditioned Gaussians from a numpy seed.  With `raw_wlen`, a tree also
carries the raw stream the raw-waveform cfgs read,
`data/raw_200ms/<split>/feats_raw.scp`: per utterance a waveform whose
frequency follows each frame's pdf, plus noise, cut by `save_raw_fea`'s
`window_signal` into one window of `raw_wlen` samples per label frame
(3200 is the recipes' 200 ms at 16 kHz; narrower windows keep a test
small), so features and labels share one rate.  The QLSTM's quaternion
projection needs its spliced input, (2 + 1 + 2) x the stream width, to be a
multiple of 4: a 40-dim stream gives 200.  With `wave_window`, a tree also
carries a rate-differing stream, `data/<split>/feats_wave.scp`: per
utterance the same kind of waveform as one column of 160 (T - 1) +
wave_window samples for T label frames (400 for logMelFb's 25 ms window,
160 for PASE's decimation), `wave_channels` columns for a multi-microphone
one (each its own noise), which `write_rate_cfg` points a front end at.

The LSTM, GRU and QLSTM recipes have no `*_impl` line (tpukaldi reads
`auto` then), and an override of a field the cfg lacks is refused, so a run
that wants another impl adds the line with `replace=`, e.g.
`{"lstm_orthinit = True": "lstm_orthinit = True\nlstm_impl = scan"}`.  The
raw recipes' layer 0 is chosen by `TPUKALDI_CONV_IMPL` (`models/cnn.py`).
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import re
import shutil
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..config.cfg import ExperimentConfig
from ..config.model_dsl import used_names
from ..graph.compiler import build_graph, init_graph
from ..io import (
    ArkScpWriter,
    compute_cmvn_stats,
    read_mat_ark,
    write_mat,
    write_vec_int,
)
from ..io.feats import load_counts
from ..io.transition_model import (
    HmmState,
    TransitionModel,
    write_transition_model,
)
from ..plan import build_plan
from ..plan.planner import ExperimentPlan
from ..train.checkpoint import save_all
from ..train.chunk_runtime import (
    ChunkRuntime,
    batch_seed,
    out_lengths,
    read_info,
)
from ..train.step import forward_step, train_step
from .save_raw_fea import window_signal

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# the recipe cfg of each front-end class the port runs end to end
RECIPES = {
    "liGRU": ("TIMIT", "liGRU_fmllr.cfg"),
    "LSTM": ("TIMIT", "LSTM_fmllr.cfg"),
    "GRU": ("TIMIT", "GRU_fmllr.cfg"),
    "QLSTM": ("DIRHA", "QLSTM_mfcc.cfg"),
    "CNN": ("TIMIT", "CNN_raw.cfg"),
    "SincNet": ("TIMIT", "SincNet_raw.cfg"),
    # the rest of the shipped zoo, one recipe a class
    "RNN": ("TIMIT", "RNN_fmllr.cfg"),
    "minimalGRU": ("TIMIT", "minimalGRU_fbank.cfg"),
    "LSTM_cudnn": ("TIMIT", "LSTM_fmllr_cudnn.cfg"),
    "SRU": ("TIMIT", "SRU_fbank.cfg"),
    "fusionRNN": ("DIRHA", "fusionRNN_mfcc_6ch.cfg"),
}

# the label frames of the raw stream: 25 ms windows every 10 ms at 16 kHz
FS, LAB_WLEN, LAB_WSHIFT = 16000, 400, 160


def recipe_cfg(arch_class: str) -> str:
    """The recipe cfg of a front-end class: the TIMIT fMLLR recipes of the
    liGRU, LSTM and GRU, the TIMIT raw-waveform recipes of the CNN and
    SincNet, the DIRHA mfcc recipe of the QLSTM; and one recipe of each
    class of the rest of the zoo (the DIRHA fusionRNN's 6-mic stream needs
    a tree whose width divides by 6, e.g. 240)."""
    return os.path.join(_REPO, "cfg", *RECIPES[arch_class])


FLAGSHIP_CFG = recipe_cfg("liGRU")

# alignment dir of each split, per corpus layout (the recipes' lab_folder)
_ALI_DIRS = {
    "TIMIT": {"train": "dnn4_pretrain-dbn_dnn_ali",
              "dev": "dnn4_pretrain-dbn_dnn_ali_dev",
              "test": "dnn4_pretrain-dbn_dnn_ali_test"},
    "DIRHA": {"train": "dnn4_pretrain-dbn_dnn_ali",
              "dev": "dnn4_pretrain-dbn_dnn_ali",
              "test": "dnn4_pretrain-dbn_dnn_ali"},
}


def transition_model(n_phones: int, n_pdfs: int) -> TransitionModel:
    """3-state Bakis HMMs over `n_phones` phones with `n_pdfs` pdfs: pdf k
    belongs to (phone, state) pair k mod 3*n_phones, so a (phone, state)
    carries several context-dependent pdfs once n_pdfs > 3*n_phones."""
    entry = [
        HmmState(0, 0, [(0, 0.5), (1, 0.5)]),
        HmmState(1, 1, [(1, 0.5), (2, 0.5)]),
        HmmState(2, 2, [(2, 0.5), (3, 0.5)]),
    ]
    phones = list(range(1, n_phones + 1))
    pairs = 3 * n_phones
    tuples = sorted(
        (k % pairs // 3 + 1, k % 3, k, k) for k in range(n_pdfs))
    id2pdf, id2phone = [0], [0]
    for phone, state, fwd, selfp in tuples:
        for nxt, _ in entry[state].transitions:
            id2pdf.append(selfp if nxt == state else fwd)
            id2phone.append(phone)
    return TransitionModel(
        phones=phones, topology={p: entry for p in phones}, tuples=tuples,
        id2pdf=np.array(id2pdf), id2phone=np.array(id2phone))


def write_kaldi_tree(
    root: str,
    dim: int,
    n_phones: int,
    n_pdfs: int,
    splits: Dict[str, Tuple[int, int, int]],
    seed: int = 21,
    corpus: str = "TIMIT",
    raw_wlen: Optional[int] = None,
    wave_window: Optional[int] = None,
    wave_channels: int = 1,
) -> str:
    """Write the tree under `root` in `corpus`'s layout (TIMIT or DIRHA);
    `splits` maps train/dev/test to (utterances, min frames, max frames).
    `raw_wlen` adds the raw stream, windows of that many samples;
    `wave_window` the rate-differing wave stream of `wave_channels`
    columns."""
    tm = transition_model(n_phones, n_pdfs)
    rng = np.random.default_rng(seed)
    # the waveforms draw from their own generator: the other streams stay
    # the same with or without them
    rng_raw = np.random.default_rng(seed + 1)
    rng_wave = np.random.default_rng(seed + 2)
    means = rng.standard_normal((tm.num_pdfs, dim)) * 2.0
    os.makedirs(os.path.join(root, "exp", "tri3", "graph"), exist_ok=True)
    for n_split, (split, (n, lo, hi)) in enumerate(splits.items(), 1):
        d = os.path.join(root, "data", split)
        alidir = os.path.join(root, "exp", _ALI_DIRS[corpus][split])
        os.makedirs(d, exist_ok=True)
        os.makedirs(alidir, exist_ok=True)
        write_transition_model(tm, os.path.join(alidir, "final.mdl"))
        cmvn: Dict[str, np.ndarray] = {}
        ali_buf = io.BytesIO()
        raw = contextlib.nullcontext()
        if raw_wlen:
            raw_dir = os.path.join(root, "data", "raw_200ms", split)
            os.makedirs(raw_dir, exist_ok=True)
            raw = ArkScpWriter(os.path.join(raw_dir, "feats_raw.ark"),
                               os.path.join(raw_dir, "feats_raw.scp"))
        wave = contextlib.nullcontext()
        if wave_window:
            wave = ArkScpWriter(os.path.join(d, "feats_wave.ark"),
                                os.path.join(d, "feats_wave.scp"))
        with ArkScpWriter(os.path.join(d, "feats.ark"),
                          os.path.join(d, "feats.scp")) as w, \
                open(os.path.join(d, "utt2spk"), "w") as u2s, raw as rw, \
                wave as ww:
            for i in range(n):
                T = int(rng.integers(lo, hi + 1))
                tids = rng.integers(1, tm.num_transition_ids + 1, T)
                pdfs = tm.transition_ids_to_pdfs(tids)
                fea = means[pdfs] + 0.5 * rng.standard_normal((T, dim))
                spk = f"{split}spk{i % 4}"
                key = f"{spk}_u{i:04d}"
                w.write(key, fea.astype(np.float32))
                if raw_wlen:
                    rw.write(key, raw_windows(pdfs, tm.num_pdfs, raw_wlen,
                                              rng_raw))
                if wave_window:
                    ww.write(key, np.stack(
                        [waveform(pdfs, tm.num_pdfs, wave_window, rng_wave)
                         for _ in range(wave_channels)],
                        axis=1).astype(np.float32))
                u2s.write(f"{key} {spk}\n")
                write_vec_int(ali_buf, tids, key=key)
                cmvn[spk] = cmvn.get(spk, 0) + compute_cmvn_stats(fea)
        with gzip.open(os.path.join(alidir, f"ali.{n_split}.gz"), "wb") as f:
            f.write(ali_buf.getvalue())
        # the cfgs list these corpus streams (DIRHA's fusionRNN cfg the
        # 6-mic mfcc_6ch); alias the same ark for each
        for stream in ("mfcc", "fbank", "fmllr", "mfcc_6ch"):
            shutil.copyfile(os.path.join(d, "feats.scp"),
                            os.path.join(d, f"feats_{stream}.scp"))
            os.makedirs(os.path.join(root, stream), exist_ok=True)
            with open(os.path.join(root, stream, f"cmvn_{split}.ark"), "wb") as cf:
                for spk, st in cmvn.items():
                    write_mat(cf, st, key=spk)
    return root


def waveform(pdfs: np.ndarray, n_pdfs: int, tail: int,
             rng: np.random.Generator) -> np.ndarray:
    """A synthetic float64 waveform of 160 (T - 1) + tail samples for T
    label frames: a sinusoid whose frequency follows each 10 ms frame's pdf
    (150-3950 Hz), plus noise, peak-normalised as `dump_raw_features`
    normalises."""
    T = len(pdfs)
    n = (T - 1) * LAB_WSHIFT + tail
    frame = np.minimum(np.arange(n) // LAB_WSHIFT, T - 1)
    freq = 150.0 + 3800.0 * pdfs[frame] / n_pdfs
    sig = np.sin(2 * np.pi * freq * np.arange(n) / FS)
    sig += 0.05 * rng.standard_normal(n)
    return sig / np.abs(sig).max()


def raw_windows(pdfs: np.ndarray, n_pdfs: int, wlen: int,
                rng: np.random.Generator) -> np.ndarray:
    """(T, wlen) float32 windows of a synthetic waveform for T label frames
    (`waveform`), cut by `window_signal`.  T * 160 + 400 samples give
    exactly T windows."""
    T = len(pdfs)
    sig = waveform(pdfs, n_pdfs, LAB_WSHIFT + LAB_WLEN, rng)
    windows = window_signal(sig, wlen, LAB_WLEN, LAB_WSHIFT)
    assert windows.shape == (T, wlen), windows.shape
    return windows.astype(np.float32)


def _write_cfg(text: str, tree: str, out_folder: str, cfg_path: str,
               replace: Optional[Dict[str, str]], recipe: str) -> str:
    text, n = re.subn(r"^out_folder = .*$", lambda _: f"out_folder = {out_folder}",
                      text, count=1, flags=re.M)
    if n != 1:
        raise ValueError(f"no out_folder line in {recipe}")
    for old, new in (replace or {}).items():
        if old not in text:
            raise ValueError(f"cfg line {old!r} not found in {recipe}")
        text = text.replace(old, new)
    text = text.replace("$KALDI_TIMIT", tree).replace("$KALDI_DIRHA", tree)
    with open(cfg_path, "w") as f:
        f.write(text)
    return cfg_path


def write_train_cfg(
    tree: str,
    out_folder: str,
    cfg_path: str,
    replace: Optional[Dict[str, str]] = None,
    recipe: str = FLAGSHIP_CFG,
) -> str:
    """The recipe cfg as it is (train on TIMIT_tr, validate on TIMIT_dev,
    forward TIMIT_test, each split with its labels) pointed at `tree`.
    `replace` maps cfg lines to their substitutes (e.g. to shrink a run or
    cut its epochs)."""
    with open(recipe) as f:
        return _write_cfg(f.read(), tree, out_folder, cfg_path, replace,
                          recipe)


def write_prod_cfg(
    tree: str,
    out_folder: str,
    cfg_path: str,
    replace: Optional[Dict[str, str]] = None,
    recipe: str = FLAGSHIP_CFG,
) -> str:
    """The recipe cfg in production (transcription-only) mode: a
    `<corpus>_prod` dataset (`TIMIT_prod`, `DIRHA_prod`) over the test
    features with `lab_name=none` (the pattern of
    cfg/TIMIT/MLP_fbank_prod.cfg) and `forward_with = <corpus>_prod`.
    `replace` maps cfg lines to their substitutes (e.g. to shrink a run)."""
    with open(recipe) as f:
        text = f.read()
    test_name = re.search(r"^forward_with = (\S+)_test$", text, re.M).group(1)
    test_block = text[text.index("[dataset3]"):text.index("[data_use]")]
    lab = test_block[test_block.index("lab = "):test_block.index("n_chunks")]
    prod_block = test_block.replace("[dataset3]", "[dataset4]").replace(
        f"data_name = {test_name}_test", f"data_name = {test_name}_prod")
    prod_block = (
        prod_block[: prod_block.index("lab = ")]
        + "lab = lab_name=none\n"
        + re.search(r"^[ \t]*lab_data_folder=.*\n", lab, re.M).group(0)
        + re.search(r"^[ \t]*lab_graph=.*\n", lab, re.M).group(0) + "\n"
        + prod_block[prod_block.index("n_chunks"):]
    )
    text = text.replace("[data_use]", prod_block + "[data_use]")
    text = text.replace(f"forward_with = {test_name}_test",
                        f"forward_with = {test_name}_prod")
    return _write_cfg(text, tree, out_folder, cfg_path, replace, recipe)


# the rate-differing front ends `write_rate_cfg` puts before the flagship's
# liGRU: their [architecture] sections (optimizer lines as the flagship's),
# the samples a label frame's window spans (max_seq_length's 6th entry)
# and their [model] lines, which end in `out_fe`
_RMSPROP = """arch_lr = 0.0004
arch_halving_factor = 0.5
arch_improvement_threshold = 0.001
arch_opt = rmsprop
opt_momentum = 0.0
opt_alpha = 0.95
opt_eps = 1e-8
opt_centered = False
opt_weight_decay = 0.0
"""
_FRONT_ARCH = """[{section}]
arch_name = {name}
arch_proto = proto/{proto}.proto
arch_library = tpukaldi.models
arch_class = {cls}
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
{options}""" + _RMSPROP
_LOGMEL = dict(name="logmel_front", proto="logMelFb", cls="logMelFb",
               options="logmelfb_nr_filt = 40\n"
                       "logmelfb_stft_window_size = 400\n"
                       "logmelfb_stft_window_shift = 160\n")
RATE_FRONTS = {
    # 40 mels, TIMIT's fbank width, over 25 ms windows every 10 ms
    "logMelFb": ([_LOGMEL], LAB_WLEN, "out_fe=compute(logmel_front,wave)"),
    # PASE at its published defaults; its frames need window = shift =
    # its decimation, 160
    "PASE": ([dict(name="PASE_front", proto="PASE", cls="PASE",
                   options="pase_cfg = {pase_cfg}\npase_model = none\n")],
             LAB_WSHIFT, "out_fe=compute(PASE_front,wave)"),
    # six microphones averaged with equal weights, then logMelFb
    "chavg_logMelFb": (
        [dict(name="chavg_front", proto="channelAvg",
              cls="channel_averaging",
              options="chAvg_channelWeights = 1,1,1,1,1,1\n"), _LOGMEL],
        LAB_WLEN,
        "out_ch=compute(chavg_front,wave)\n\tout_fe=compute(logmel_front,out_ch)"),
}


def write_rate_cfg(
    tree: str,
    out_folder: str,
    cfg_path: str,
    front: str = "logMelFb",
    replace: Optional[Dict[str, str]] = None,
    pase_cfg: str = "",
    recurrent: bool = True,
) -> str:
    """The flagship recipe with its fMLLR input replaced by a tree's wave
    stream (`write_kaldi_tree(..., wave_window=...)`) through a front end of
    `RATE_FRONTS`: logMelFb (40 mels, window 400, shift 160), PASE (the
    `pase_cfg` json; its defaults without one) or channel_averaging over
    the stream's columns then logMelFb, then the 5x550 liGRU and its two
    heads, or the heads alone with `recurrent=False`.  The 6-int
    `max_seq_length_train = 32000,32000,199,199,160,<window>` reads the
    samples against the label frames (no curriculum).  `replace` maps cfg
    lines to their substitutes, after these edits."""
    sections, window, model = RATE_FRONTS[front]
    with open(FLAGSHIP_CFG) as f:
        text = f.read()
    # the wave stream after each dataset's last (fmllr) stream
    text, n = re.subn(
        r"(\tfea_lst=\$KALDI_TIMIT/data/(\w+)/feats_fmllr\.scp\n"
        r"(?:\t.*\n)*?\tcw_right=0\n)\n",
        lambda m: (m.group(1) + "\t\n\tfea_name=wave\n"
                   f"\tfea_lst=$KALDI_TIMIT/data/{m.group(2)}/feats_wave.scp\n"
                   "\tfea_opts=copy-feats ark:- ark:- |\n"
                   "\tcw_left=0\n\tcw_right=0\n\n"), text)
    if n != 3:
        raise ValueError(f"{n} fmllr streams in {FLAGSHIP_CFG}, expected 3")
    edits = {
        "max_seq_length_train = 1000":
            f"max_seq_length_train = 32000,32000,199,199,{LAB_WSHIFT},{window}",
        "increase_seq_length_train = True": "increase_seq_length_train = False",
        "out_dnn1=compute(liGRU_layers,fmllr)":
            model + ("\n\tout_dnn1=compute(liGRU_layers,out_fe)"
                     if recurrent else ""),
        "[model]": "".join(
            _FRONT_ARCH.format(section=f"architecture{4 + i}",
                               options=a["options"].format(pase_cfg=pase_cfg),
                               **{k: a[k] for k in ("name", "proto", "cls")})
            + "\n" for i, a in enumerate(sections)) + "[model]",
    }
    if not recurrent:
        beg = text.index("[architecture1]")
        text = text[:beg] + text[text.index("[architecture2]"):]
    for old, new in edits.items():
        if old not in text:
            raise ValueError(f"cfg line {old!r} not found in {FLAGSHIP_CFG}")
        text = text.replace(old, new)
    if not recurrent:
        # the heads read the front end's output
        text = text.replace("out_fe", "out_dnn1")
    return _write_cfg(text, tree, out_folder, cfg_path, replace, FLAGSHIP_CFG)


def _seeded_graph(cfg_path: str, dim: int):
    """The port's init of the cfg's graph from its `seed` (random weights),
    on the CPU; `dim` is the tree's stream width (for a raw stream, its
    window length), which each stream the [model] reads splices (cw_left + 1
    + cw_right) times."""
    exp = load_config(cfg_path)
    ds = next(iter(exp.datasets.values()))
    layout, off = {}, 0
    for name in used_names(exp.model, list(ds.features), "input"):
        width = dim * ds.features[name].spliced_factor
        layout[name] = (off, off + width)
        off += width
    graph = build_graph(exp, layout, {}, "cpu")
    init_graph(graph, exp.seed)
    return exp, graph


def save_seeded_finals(cfg_path: str, dim: int) -> Dict[str, str]:
    """Save the port's seeded init as the final checkpoints a production run
    of the cfg reads.  Returns arch -> checkpoint path."""
    exp, graph = _seeded_graph(cfg_path, dim)
    finals = build_plan(exp).final_ckpts
    save_all(finals, graph.modules)
    return finals


def save_seeded_init(cfg_path: str, dim: int, folder: str) -> List[str]:
    """Save the port's seeded init as one checkpoint per architecture under
    `folder` (weights only, so each run starts a fresh optimizer) and return
    the `--<section>,arch_pretrain_file=<path>` overrides that make a
    training run of the cfg start from them: two runs, tpukaldi's and the
    port's, then start from the same weights."""
    exp, graph = _seeded_graph(cfg_path, dim)
    os.makedirs(folder, exist_ok=True)
    paths = {a: os.path.join(folder, f"init_{a}.ckpt") for a in graph.modules}
    save_all(paths, graph.modules)
    return [f"--{exp.archs[a].section},arch_pretrain_file={p}"
            for a, p in paths.items()]


def train_plan(cfg_path: str) -> Tuple[ExperimentConfig, ExperimentPlan]:
    """The cfg and the plan a training run of it follows (tasks, their
    ledger and checkpoint files, the final checkpoints)."""
    exp = load_config(cfg_path)
    return exp, build_plan(exp)


def train_step_gradients(
    cfg_path: str, device, dtype: torch.dtype = torch.float32,
) -> Tuple[float, Dict[str, torch.Tensor], Tuple[int, ...]]:
    """One train step of the cfg's seeded init on the first batch of its
    first train chunk, on `device`: (loss, {arch.param: gradient}, batch
    shape).  Two cfgs that differ only in the recurrent class's `*_impl`
    (`ligru_impl`, `lstm_impl`, `gru_impl`) give two paths to the same
    numbers.  `dtype=torch.float64` (with `*_impl = scan`: the kernels take
    float32 only) gives a reference for both, float64 except the heads'
    log-softmax and the cost means, which stay float32 as in tpukaldi.  The
    step computes in the cfg's compute dtype (`TPUKALDI_COMPUTE_DTYPE`
    overrides it): in bf16 the masters, and so the gradients, stay
    `dtype`."""
    exp, plan = train_plan(cfg_path)
    task = plan.epochs[0].tasks[0]
    rt = ChunkRuntime(exp, device)
    chunk = rt.load_task_chunk(task)
    rt.ensure_initialized(chunk, with_optimizers=True)
    for module in rt.graph.modules.values():
        module.to(dtype)
    batch_size = rt._effective_bs(chunk, exp.batches.batch_size_train[0])
    batch = next(rt._batches(chunk, batch_size, True, task.seed))
    # a host batch, or on a card the device cache's gather
    feats, labs = rt.batch_tensors(chunk, batch)
    rt.generator.manual_seed(batch_seed(task.seed, 0))
    loss, _ = train_step(rt.graph, rt.optimizers, feats.to(dtype), labs,
                         getattr(batch, "n_valid_t", None), rt.generator,
                         rt.compute_dtype)
    grads = {f"{a}.{n}": p.grad.detach().clone()
             for a, m in rt.graph.modules.items()
             for n, p in m.named_parameters()}
    return loss.item(), grads, tuple(feats.shape)


def forward_outputs(
    out_folder: str,
) -> Tuple[Iterator[Tuple[str, np.ndarray]], Dict[str, float]]:
    """The posteriors (key, (T, C) matrix) in ark order and the `.info`
    fields of a run with one forward task and one decoded output."""
    ef = os.path.join(out_folder, "exp_files")
    arks = sorted(f for f in os.listdir(ef) if f.endswith("_to_decode.ark"))
    infos = sorted(f for f in os.listdir(ef)
                   if f.startswith("forward_") and f.endswith(".info"))
    if len(arks) != 1 or len(infos) != 1:
        raise ValueError(f"expected one forward ark and .info in {ef}: "
                         f"{sorted(os.listdir(ef))}")
    return (read_mat_ark(os.path.join(ef, arks[0])),
            read_info(os.path.join(ef, infos[0])))


def forward_utterances(
    exp: ExperimentConfig,
    names: Iterable[str],
    device,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Posteriors of the first forward output for the utterances `names` of
    `exp`'s first forward task, each forwarded alone through the port's
    forward step on `device` from the run's final checkpoints.  `exp` is
    what `run_experiment` returned (its count files resolved), so the
    result is held to that run's ark.  `dtype=torch.float64` (plain paths
    only: the kernels take float32) runs the modules and the features in
    float64, a reference for the float32 paths (the heads' log-softmax
    stays float32, as in tpukaldi)."""
    task = build_plan(exp).forward_tasks[0]
    rt = ChunkRuntime(exp, device)
    chunk = rt.load_task_chunk(task)
    rt.ensure_initialized(chunk)
    rt.restore_from(task.pretrain_files)
    for module in rt.graph.modules.values():
        module.to(dtype)
    out_name = exp.forward.outs[0]
    counts = load_counts(exp.forward.counts_from[0])
    prior = torch.as_tensor(np.log(counts / counts.sum()), dtype=torch.float32,
                            device=rt.device)
    starts = [0, *chunk.end_index[:-1]]
    posts = {}
    for name in names:
        i = chunk.names.index(name)
        feats = torch.from_numpy(
            chunk.feats[int(starts[i]):int(chunk.end_index[i])]).to(
                rt.device, dtype)
        # a rate-differing utterance's frames: its label frames
        n = int(out_lengths(chunk, [feats.shape[0]])[0])
        lengths = torch.tensor([n], device=rt.device)
        outs = forward_step(rt.graph, feats[:, None, :], lengths,
                            {out_name: prior}, compute_dtype=rt.compute_dtype)
        posts[name] = outs[out_name][:n].cpu().numpy()
    return posts
