"""Serving export: a trained experiment's acoustic model as a `torch.export`
artifact (counterpart of tpukaldi's `tools/export_model.py`, which writes
a StableHLO one).

    python -m tpukaldi_torch.tools.export_model <cfg> --out <dir> \\
        [--batch N] [--platforms cpu,cuda] [--normalize]

freezes the forward function (graph DSL -> modules -> log-softmax
posteriors, optionally prior-normalised) with the trained weights into
`<dir>/forward.pt2` (`torch.export.save`) and a JSON sidecar `meta.json`
with tpukaldi's keys.  The contract is tpukaldi's:

- inputs: `(T, B, D)` float32 features, as the runtime feeds the network
  (`meta.input_contract`), and `lengths (B,)` int32 valid frame counts
  (the exact lengths-aware bidirectional reversal); T and B are symbolic
  (`torch.export.Dim`), so one artifact serves any utterance length at any
  batch size.  `--batch N` pins the batch; if the symbolic batch fails to
  export, the artifact falls back to batch 1 with a warning (`meta.batch`
  says so);
- output: `{out_name: (T*B, C)}` float32 log-posteriors, or with
  `--normalize` the count-file log-priors baked in as constants
  (the decoder's input, reference core.py:665-668);
- the compute dtype is the cfg's (`meta.compute_dtype`).

Unlike tpukaldi's StableHLO artifact, the graph names the port's custom
ops (`kernels/ops.py`: one node per recurrence or fused conv layer, which
keeps T symbolic and runs the hand kernels on a card), so loading it
needs the port: `load_exported` imports the ops, and serves on the card
by default (the artifact is traced on the CPU and moved to the serving
device when loaded; `meta.platforms` lists both).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

PLATFORMS = ("cpu", "cuda")


def _sample_chunk(exp, n_utts: int = 1):
    """A tiny fea-only chunk of the forward dataset, to find the feature
    layout (splice and context widths) as the runtime would."""
    from ..config.model_dsl import used_names
    from ..data.chunk_loader import load_chunk

    ds = exp.datasets[exp.forward_with[0]]
    fea_names = used_names(exp.model, list(ds.features), "input") or list(
        ds.features)
    tmp = tempfile.mkdtemp(prefix="tpukaldi_torch_export_")
    try:
        overrides = {}
        for name in fea_names:
            with open(ds.features[name].lst) as fh:
                lines = [ln for ln in fh.read().splitlines()
                         if ln.strip()][:n_utts]
            path = os.path.join(tmp, f"{name}.lst")
            with open(path, "w") as fh:
                fh.write("\n".join(lines) + "\n")
            overrides[name] = path
        msl = exp.batches.msl_for_phase("forward", 0)
        return load_chunk(ds, fea_names, [], msl, fea_only=True,
                          fea_lst_override=overrides)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class ServingModule(nn.Module):
    """The trained forward as one module: `forward(feats, lengths)` ->
    {out_name: (T*B, C) log-posteriors}, the graph's modules in eval mode
    and without gradients, the log-priors as buffers."""

    def __init__(self, graph, log_priors: Dict[str, np.ndarray],
                 compute_dtype=None):
        super().__init__()
        self.archs = nn.ModuleDict(graph.modules)
        self.graph = graph
        self.compute_dtype = compute_dtype
        self.prior_names = {}
        for i, (name, prior) in enumerate(sorted(log_priors.items())):
            self.register_buffer(f"log_prior_{i}", torch.as_tensor(
                prior, dtype=torch.float32))
            self.prior_names[name] = f"log_prior_{i}"

    def forward(self, feats: torch.Tensor,
                lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        from ..train.step import forward_outputs

        priors = {name: getattr(self, buf)
                  for name, buf in self.prior_names.items()}
        with torch.no_grad():
            return forward_outputs(self.graph, feats, lengths, priors or None,
                                   compute_dtype=self.compute_dtype)


def _load_trained(cfg_path: str):
    """(exp, graph on the CPU with the final checkpoints loaded, the
    features' width)."""
    from ..config import load_config
    from ..graph.compiler import build_graph, init_graph
    from ..train import checkpoint as ckpt

    exp = load_config(cfg_path)
    chunk = _sample_chunk(exp)
    graph = build_graph(exp, chunk.fea_layout, chunk.lab_layout, "cpu")
    init_graph(graph, exp.seed)
    exp_files = os.path.join(exp.out_folder, "exp_files")
    finals = {a: os.path.join(exp_files, f"final_{a}.ckpt")
              for a in graph.arch_names}
    missing = [p for p in finals.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"final checkpoints not found (train first): {missing}")
    ckpt.load_all(finals, graph.modules)
    for module in graph.modules.values():
        module.eval()
    return exp, graph, int(chunk.feats.shape[-1])


def _log_priors(exp) -> Dict[str, np.ndarray]:
    """out_name -> log(counts / sum(counts)) of each normalised output."""
    from ..forward.counts import resolve_count_files
    from ..io.feats import load_counts

    resolve_count_files(exp, os.path.join(exp.out_folder, "exp_files"))
    priors = {}
    for i, out in enumerate(exp.forward.outs):
        if exp.forward.normalize_posteriors[i]:
            counts = np.maximum(load_counts(exp.forward.counts_from[i]), 1.0)
            priors[out] = np.log(counts / counts.sum()).astype(np.float32)
    return priors


def export_forward(
    cfg_path: str,
    out_dir: str,
    batch: int = 0,
    platforms: Optional[list] = None,
    normalize: bool = False,
) -> str:
    """Export the trained forward function; returns the artifact dir."""
    from ..kernels import ops  # noqa: F401  (registers the custom ops)
    from ..train.chunk_runtime import compute_dtype as exp_compute_dtype

    platforms = list(platforms or PLATFORMS)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"platforms {unknown}: the port serves on "
                         f"{', '.join(PLATFORMS)}")
    exp, graph, D = _load_trained(cfg_path)
    log_priors = _log_priors(exp) if normalize else {}
    # the experiment's compute dtype: a bf16 cfg exports the numerics its
    # ledger and decode posteriors used
    cdt = exp_compute_dtype(exp)
    module = ServingModule(graph, log_priors, cdt)

    def _export(b: int):
        T = torch.export.Dim("t", min=1)
        B = torch.export.Dim("b", min=1) if b == 0 else None
        bb = 2 if b == 0 else b
        feats = torch.zeros((5, bb, D), dtype=torch.float32)
        lengths = torch.full((bb,), 5, dtype=torch.int32)
        dims = {"feats": {0: T, 1: B} if B is not None else {0: T},
                "lengths": {0: B} if B is not None else None}
        return torch.export.export(module, (feats, lengths),
                                   dynamic_shapes=dims, strict=False)

    try:
        exported, exported_batch = _export(batch), batch
    except Exception as e:
        if batch != 0:
            raise
        # a graph that resists a symbolic batch exports at batch 1, and
        # says so: the serving contract (meta.batch) changes
        logging.warning("symbolic-batch export failed (%s: %s); falling "
                        "back to a fixed batch=1 artifact",
                        type(e).__name__, e)
        exported, exported_batch = _export(1), 1

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, "forward.pt2"))
    ds = exp.datasets[exp.forward_with[0]]
    meta = {
        "format": "tpukaldi-torch-serving-v1",
        "inp_dim": D,
        "batch": int(exported_batch),  # 0 = symbolic (any batch size)
        "seq_model": bool(graph.seq_model),
        "outs": list(exp.forward.outs),
        "normalized": sorted(log_priors),
        "platforms": platforms,
        "compute_dtype": "bfloat16" if cdt is not None else "float32",
        # the artifact consumes loader-processed features: the (T, B, D)
        # tensors the runtime feeds the network, after the per-stream
        # fea_opts, the context-window splice and the per-chunk CMVN
        "input_contract": {
            "preprocessing": "fea_opts + splice + per-chunk CMVN "
            "(tpukaldi_torch.data.chunk_loader semantics)",
            "streams": {
                name: {"cw_left": f.cw_left, "cw_right": f.cw_right,
                       "fea_opts": f.opts}
                for name, f in ds.features.items()
            },
        },
        "loader": "torch.export.load after importing "
                  "tpukaldi_torch.kernels.ops (tools/export_model.py::"
                  "load_exported)",
        "source_cfg": os.path.abspath(cfg_path),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ExportedModel:
    """A reloaded serving artifact on `device`: `call(feats (T, B, D) or
    (T, D), lengths (B,)) -> {out_name: (T*B, C) log-posteriors}` as
    float32 tensors on that device."""

    def __init__(self, art_dir: str, device="cuda"):
        from ..kernels import ops  # noqa: F401  (the graph names them)
        from ..train.chunk_runtime import resolve_device

        self.device = resolve_device(device)
        with open(os.path.join(art_dir, "meta.json")) as f:
            self.meta = json.load(f)
        program = torch.export.load(os.path.join(art_dir, "forward.pt2"))
        if self.device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self.program = program
        self._fn = program.module()

    def call(self, feats, lengths=None) -> Dict[str, torch.Tensor]:
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        if feats.ndim == 2:
            feats = feats[:, None, :]
        if lengths is None:
            lengths = [feats.shape[0]] * feats.shape[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(self.device)
        return self._fn(feats, lengths)


def load_exported(art_dir: str, device="cuda") -> ExportedModel:
    """The artifact in `art_dir`, served on `device` (the card unless the
    caller asks for the CPU)."""
    return ExportedModel(art_dir, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpukaldi_torch.tools.export_model",
        description="Export a trained tpukaldi_torch model to a "
        "torch.export serving artifact.")
    ap.add_argument("cfg", help="experiment cfg (training must be complete)")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch size of the artifact; 0 (default) = "
                    "symbolic, serves any batch size")
    ap.add_argument("--platforms", default=None,
                    help="comma list of cpu,cuda (default: both)")
    ap.add_argument("--normalize", action="store_true",
                    help="bake count-file log-priors into the output "
                    "(emit decoder-ready normalized posteriors)")
    args = ap.parse_args(argv)
    platforms = args.platforms.split(",") if args.platforms else None
    out = export_forward(args.cfg, args.out, batch=args.batch,
                         platforms=platforms, normalize=args.normalize)
    print(f"exported -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
