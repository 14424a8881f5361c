"""[model] DSL -> a program over the port's nn.Modules (counterpart of
`tpukaldi/graph/compiler.py`, reference utils.py:2031-2419).

`build_graph` instantiates one module per architecture and chains the
dimensions through the program; `init_graph` initialises every module from
one seeded generator; `apply_graph` runs the program, stopping in forward
mode once every requested output exists.

Shape adaptation as in the reference (utils.py:2320-2339): sequential
architectures see (T, B, F), non-sequential ones (T*B, F); costs flatten to
(N, C) with integer labels (N,).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from tpukaldi.config.cfg import ArchSpec, ExperimentConfig
from tpukaldi.config.model_dsl import ModelStatement

from ..models.registry import resolve


@dataclass
class GraphSpec:
    """The [model] program compiled against a data layout."""

    stmts: List[ModelStatement]
    modules: Dict[str, nn.Module]  # arch_name -> module, on `device`
    archs: Dict[str, ArchSpec]
    fea_layout: Dict[str, Tuple[int, int]]
    lab_layout: Dict[str, int]
    out_dims: Dict[str, int]
    seq_model: bool
    forward_outs: List[str] = field(default_factory=list)

    @property
    def arch_names(self) -> List[str]:
        return list(self.modules)


def build_graph(
    exp: ExperimentConfig,
    fea_layout: Dict[str, Tuple[int, int]],
    lab_layout: Dict[str, int],
    device,
) -> GraphSpec:
    """Instantiate modules on `device` and chain dims through the program
    (reference model_init, utils.py:2031-2103)."""
    modules: Dict[str, nn.Module] = {}
    out_dims: Dict[str, int] = {
        name: end - beg for name, (beg, end) in fea_layout.items()
    }
    used_archs: Dict[str, ArchSpec] = {}
    for s in exp.model:
        if s.op == "compute":
            arch = exp.archs[s.arg1]
            inp_dim = out_dims[s.arg2]
            if s.arg1 not in modules:
                cls = resolve(arch.class_name, arch.library)
                modules[s.arg1] = cls(arch.options, inp_dim, device=device)
                used_archs[s.arg1] = arch
            out_dims[s.out] = modules[s.arg1].compute_out_dim(arch.options, inp_dim)
        elif s.op == "concatenate":
            out_dims[s.out] = out_dims[s.arg1] + out_dims[s.arg2]
        elif s.op in ("cost_nll", "cost_err", "mse"):
            out_dims[s.out] = 1
        else:  # mult/sum/avg/const ops preserve dims
            out_dims[s.out] = out_dims[s.arg1]
    return GraphSpec(
        stmts=list(exp.model),
        modules=modules,
        archs=used_archs,
        fea_layout=fea_layout,
        lab_layout=lab_layout,
        out_dims=out_dims,
        seq_model=any(a.seq_model for a in used_archs.values()),
        forward_outs=list(exp.forward.outs),
    )


def init_graph(graph: GraphSpec, seed: int) -> None:
    """Initialise every module, in program order, from one CPU generator
    seeded with `seed` (the same weights on any device)."""
    generator = torch.Generator().manual_seed(seed)
    for module in graph.modules.values():
        module.reset_parameters(generator)


def _feature_slices(graph: GraphSpec, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        name: feats[..., beg:end] for name, (beg, end) in graph.fea_layout.items()
    }


def _adapt_for_arch(x: torch.Tensor, arch_is_seq: bool, ref: torch.Tensor):
    """2D<->3D shim (utils.py:2320-2339)."""
    if x.ndim == 3 and not arch_is_seq:
        return x.reshape(x.shape[0] * x.shape[1], -1)
    if x.ndim == 2 and arch_is_seq:
        return x.reshape(ref.shape[0], ref.shape[1], -1)
    return x


def _flatten_out(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], -1) if x.ndim == 3 else x


def _harmonize(a: torch.Tensor, b: torch.Tensor):
    """Flatten to 2D when mixing seq (3D) and non-seq (2D) outputs."""
    if a.ndim != b.ndim:
        a, b = _flatten_out(a), _flatten_out(b)
    return a, b


def _row_mask(tb3: torch.Tensor, n_valid_t) -> torch.Tensor:
    """Flattened (T*B,) mask of rows with t < n_valid_t."""
    T, B = tb3.shape[0], tb3.shape[1]
    t = torch.arange(T, device=tb3.device)[:, None]
    return (t < n_valid_t).float().expand(T, B).reshape(-1)


def _masked_mean(vals: torch.Tensor, mask: Optional[torch.Tensor]):
    """Mean of per-row cost values without bucket-padding rows (see
    tpukaldi's `_masked_mean`); a missing or shape-mismatched mask gives
    the plain mean."""
    vals = vals.float()
    if mask is None or vals.shape[0] != mask.shape[0]:
        return vals.mean()
    return (vals * mask).sum() / mask.sum().clamp_min(1.0)


def apply_graph(
    graph: GraphSpec,
    feats: torch.Tensor,
    labs: Optional[torch.Tensor] = None,
    train: bool = False,
    to_do: str = "train",
    lengths: Optional[torch.Tensor] = None,
    n_valid_t=None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Execute the program; returns every computed output by name.

    `to_do='forward'` stops once every forward output exists and skips the
    costs (reference core.py:616-629 / utils.py:2341-2342).  `n_valid_t` is
    the unbucketed batch-max length; cost rows at t >= n_valid_t are
    bucket padding and are left out of the cost means.
    """
    outs = _feature_slices(graph, feats)
    # forward mode stops once every requested output exists (tracked as a
    # set: forward_out order need not follow program order); outputs that
    # are raw feature slices drain up front, skipped costs drain too
    if to_do == "forward":
        pending_fwd = set(graph.forward_outs) - set(outs)
        if not pending_fwd:
            return outs
    else:
        pending_fwd = set()

    def _drained(name):
        pending_fwd.discard(name)
        return not pending_fwd

    lab_mask = (
        _row_mask(labs, n_valid_t)
        if n_valid_t is not None and labs is not None and labs.ndim == 3
        else None
    )
    # a feature-rate mask only when features run at the label rate
    fea_mask = (
        _row_mask(feats, n_valid_t)
        if n_valid_t is not None
        and feats.ndim == 3
        and (labs is None or labs.ndim != 3 or labs.shape[0] == feats.shape[0])
        else None
    )

    def get_label(name):
        return labs[..., graph.lab_layout[name]].reshape(-1).long()

    for s in graph.stmts:
        if s.op == "compute":
            module = graph.modules[s.arg1]
            arch = graph.archs[s.arg1]
            module.train(train and not arch.freeze)
            inp = _adapt_for_arch(outs[s.arg2], arch.seq_model, feats)
            if arch.seq_model and lengths is not None:
                outs[s.out] = module(inp, lengths=lengths, generator=generator)
            else:
                outs[s.out] = module(inp, generator=generator)
        elif s.op in ("cost_nll", "cost_err"):
            if to_do == "forward":
                if _drained(s.out):
                    break
                continue
            logp = _flatten_out(outs[s.arg1])
            y = get_label(s.arg2)
            if s.op == "cost_nll":
                vals = -logp.gather(1, y[:, None])[:, 0]
            else:
                vals = (logp.argmax(dim=1) != y).float()
            outs[s.out] = _masked_mean(vals, lab_mask)
        elif s.op == "concatenate":
            a, b = _harmonize(outs[s.arg1], outs[s.arg2])
            outs[s.out] = torch.cat([a, b], dim=a.ndim - 1)
        elif s.op == "mult":
            a, b = _harmonize(outs[s.arg1], outs[s.arg2])
            outs[s.out] = a * b
        elif s.op == "sum":
            a, b = _harmonize(outs[s.arg1], outs[s.arg2])
            outs[s.out] = a + b
        elif s.op == "avg":
            a, b = _harmonize(outs[s.arg1], outs[s.arg2])
            outs[s.out] = (a + b) / 2
        elif s.op == "mult_constant":
            outs[s.out] = outs[s.arg1] * float(s.arg2)
        elif s.op == "sum_constant":
            outs[s.out] = outs[s.arg1] + float(s.arg2)
        elif s.op == "mse":
            a, b = _harmonize(outs[s.arg1], outs[s.arg2])
            sq = (a - b).float() ** 2
            if sq.ndim == 3:
                sq = sq.reshape(sq.shape[0] * sq.shape[1], -1)
            vals = sq.mean(dim=1)
            # strict row-count match: never a mask built for another rate
            mask = next((m for m in (fea_mask, lab_mask)
                         if m is not None and vals.shape[0] == m.shape[0]), None)
            outs[s.out] = _masked_mean(vals, mask)
        if pending_fwd and _drained(s.out):
            break
    return outs
