"""A synthetic Kaldi TIMIT tree in real formats, and a TIMIT fMLLR recipe
cfg pointed at it (the flagship `cfg/TIMIT/liGRU_fmllr.cfg` by default, or
`recipe_cfg("LSTM")`, `recipe_cfg("GRU")`), for training
(`write_train_cfg`) or production forward (`write_prod_cfg`) — inputs for
running the port end to end without a corpus (`chip_smoke.py`, the tests)
— and helpers to set up and check such a run: seeded initial or final
checkpoints, the forward outputs, and a second forward of chosen
utterances.

The tree carries what those cfgs read: per split a
`feats.ark/.scp` (aliased as the mfcc/fbank/fmllr streams), `utt2spk`,
per-speaker CMVN stats, and an alignment dir with gzipped transition-id
archives and a binary `final.mdl`, so `N_out_lab_cd`/`N_out_lab_mono` and
the prior counts resolve natively (hmm-info, ali-to-pdf, analyze-counts).
Features are pdf-conditioned Gaussians from a numpy seed.

The LSTM and GRU recipes have no `lstm_impl`/`gru_impl` line (tpukaldi
reads `auto` then), and an override of a field the cfg lacks is refused, so
a run that wants another impl adds the line with `replace=`, e.g.
`{"lstm_orthinit = True": "lstm_orthinit = True\nlstm_impl = scan"}`.
"""

from __future__ import annotations

import gzip
import io
import os
import re
import shutil
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpukaldi.config import load_config
from tpukaldi.config.cfg import ExperimentConfig
from tpukaldi.io import (
    ArkScpWriter,
    compute_cmvn_stats,
    read_mat_ark,
    write_mat,
    write_vec_int,
)
from tpukaldi.io.feats import load_counts
from tpukaldi.io.transition_model import (
    HmmState,
    TransitionModel,
    write_transition_model,
)
from tpukaldi.plan import build_plan
from tpukaldi.plan.planner import ExperimentPlan

from ..graph.compiler import build_graph, init_graph
from ..train.checkpoint import save_all
from ..train.chunk_runtime import ChunkRuntime, batch_seed, read_info
from ..train.step import forward_step, train_step

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def recipe_cfg(arch_class: str) -> str:
    """The TIMIT fMLLR recipe of a recurrent class (liGRU, LSTM, GRU, ...)."""
    return os.path.join(_REPO, "cfg", "TIMIT", f"{arch_class}_fmllr.cfg")


FLAGSHIP_CFG = recipe_cfg("liGRU")

_ALI_DIRS = {
    "train": "dnn4_pretrain-dbn_dnn_ali",
    "dev": "dnn4_pretrain-dbn_dnn_ali_dev",
    "test": "dnn4_pretrain-dbn_dnn_ali_test",
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
) -> str:
    """Write the tree under `root`; `splits` maps train/dev/test to
    (utterances, min frames, max frames)."""
    tm = transition_model(n_phones, n_pdfs)
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((tm.num_pdfs, dim)) * 2.0
    os.makedirs(os.path.join(root, "exp", "tri3", "graph"), exist_ok=True)
    for split, (n, lo, hi) in splits.items():
        d = os.path.join(root, "data", split)
        alidir = os.path.join(root, "exp", _ALI_DIRS[split])
        os.makedirs(d, exist_ok=True)
        os.makedirs(alidir, exist_ok=True)
        write_transition_model(tm, os.path.join(alidir, "final.mdl"))
        cmvn: Dict[str, np.ndarray] = {}
        ali_buf = io.BytesIO()
        with ArkScpWriter(os.path.join(d, "feats.ark"),
                          os.path.join(d, "feats.scp")) as w, \
                open(os.path.join(d, "utt2spk"), "w") as u2s:
            for i in range(n):
                T = int(rng.integers(lo, hi + 1))
                tids = rng.integers(1, tm.num_transition_ids + 1, T)
                pdfs = tm.transition_ids_to_pdfs(tids)
                fea = means[pdfs] + 0.5 * rng.standard_normal((T, dim))
                spk = f"{split}spk{i % 4}"
                key = f"{spk}_u{i:04d}"
                w.write(key, fea.astype(np.float32))
                u2s.write(f"{key} {spk}\n")
                write_vec_int(ali_buf, tids, key=key)
                cmvn[spk] = cmvn.get(spk, 0) + compute_cmvn_stats(fea)
        with gzip.open(os.path.join(alidir, "ali.1.gz"), "wb") as f:
            f.write(ali_buf.getvalue())
        # the cfg lists three corpus streams; alias the same ark for each
        for stream in ("mfcc", "fbank", "fmllr"):
            shutil.copyfile(os.path.join(d, "feats.scp"),
                            os.path.join(d, f"feats_{stream}.scp"))
            os.makedirs(os.path.join(root, stream), exist_ok=True)
            with open(os.path.join(root, stream, f"cmvn_{split}.ark"), "wb") as cf:
                for spk, st in cmvn.items():
                    write_mat(cf, st, key=spk)
    return root


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
    text = text.replace("$KALDI_TIMIT", tree)
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
    `TIMIT_prod` dataset over the test features with `lab_name=none` (the
    pattern of cfg/TIMIT/MLP_fbank_prod.cfg) and `forward_with = TIMIT_prod`.
    `replace` maps cfg lines to their substitutes (e.g. to shrink a run)."""
    with open(recipe) as f:
        text = f.read()
    test_block = text[text.index("[dataset3]"):text.index("[data_use]")]
    prod_block = test_block.replace("[dataset3]", "[dataset4]").replace(
        "data_name = TIMIT_test", "data_name = TIMIT_prod")
    prod_block = (
        prod_block[: prod_block.index("lab = ")]
        + "lab = lab_name=none\n"
        + "\tlab_data_folder=$KALDI_TIMIT/data/test/\n"
        + "\tlab_graph=$KALDI_TIMIT/exp/tri3/graph\n\n"
        + prod_block[prod_block.index("n_chunks"):]
    )
    text = text.replace("[data_use]", prod_block + "[data_use]")
    text = text.replace("forward_with = TIMIT_test", "forward_with = TIMIT_prod")
    return _write_cfg(text, tree, out_folder, cfg_path, replace, recipe)


def _seeded_graph(cfg_path: str, dim: int):
    """The port's init of the cfg's graph from its `seed` (random weights),
    on the CPU; `dim` is the fmllr feature width."""
    exp = load_config(cfg_path)
    graph = build_graph(exp, {"fmllr": (0, dim)}, {}, "cpu")
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
    log-softmax and the cost means, which stay float32 as in tpukaldi."""
    exp, plan = train_plan(cfg_path)
    task = plan.epochs[0].tasks[0]
    rt = ChunkRuntime(exp, device)
    chunk = rt.load_task_chunk(task)
    rt.ensure_initialized(chunk, with_optimizers=True)
    for module in rt.graph.modules.values():
        module.to(dtype)
    batch = next(rt._batches(chunk, exp.batches.batch_size_train[0], True,
                             task.seed))
    rt.generator.manual_seed(batch_seed(task.seed, 0))
    loss, _ = train_step(rt.graph, rt.optimizers,
                         torch.from_numpy(batch.feats).to(rt.device, dtype),
                         torch.from_numpy(batch.labs).to(rt.device),
                         batch.n_valid_t, rt.generator)
    grads = {f"{a}.{n}": p.grad.detach().clone()
             for a, m in rt.graph.modules.items()
             for n, p in m.named_parameters()}
    return loss.item(), grads, tuple(batch.feats.shape)


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
) -> Dict[str, np.ndarray]:
    """Posteriors of the first forward output for the utterances `names` of
    `exp`'s first forward task, each forwarded alone through the port's
    forward step on `device` from the run's final checkpoints.  `exp` is
    what `run_experiment` returned (its count files resolved), so the
    result is held to that run's ark."""
    task = build_plan(exp).forward_tasks[0]
    rt = ChunkRuntime(exp, device)
    chunk = rt.load_task_chunk(task)
    rt.ensure_initialized(chunk)
    rt.restore_from(task.pretrain_files)
    out_name = exp.forward.outs[0]
    counts = load_counts(exp.forward.counts_from[0])
    prior = torch.as_tensor(np.log(counts / counts.sum()), dtype=torch.float32,
                            device=rt.device)
    starts = [0, *chunk.end_index[:-1]]
    posts = {}
    for name in names:
        i = chunk.names.index(name)
        feats = torch.from_numpy(
            chunk.feats[int(starts[i]):int(chunk.end_index[i])]).to(rt.device)
        lengths = torch.tensor([feats.shape[0]], device=rt.device)
        outs = forward_step(rt.graph, feats[:, None, :], lengths,
                            {out_name: prior})
        posts[name] = outs[out_name].cpu().numpy()
    return posts
