"""The train, eval and forward steps over the compiled graph (counterpart of
tpukaldi's `train/step.py`: `make_train_step`, `make_eval_step`,
`make_forward_step`; reference core.py:614-642).

Loss and err come back as device tensors: nothing here calls `.item()`, so
a step does not wait for the device (tpukaldi fetches the stats once per
chunk, `chunk_runtime.py:615-650`, and so does the port's runtime).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..graph.compiler import GraphSpec, apply_graph
from .optimizers import ArchOptimizer


def train_step(
    graph: GraphSpec,
    optimizers: Dict[str, ArchOptimizer],
    feats: torch.Tensor,
    labs: torch.Tensor,
    n_valid_t: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on `loss_final`: forward in train mode (frozen
    architectures in eval mode), backward, then a step of every unfrozen
    architecture's optimizer.  No `lengths`: tpukaldi's train step passes
    none, so bidirectional layers flip the whole bucket-padded batch.
    `generator` (on the graph's device) draws the dropout masks.
    Returns (loss, err) as detached device scalars."""
    for opt in optimizers.values():
        opt.zero_grad()
    outs = apply_graph(graph, feats, labs, train=True, to_do="train",
                       n_valid_t=n_valid_t, generator=generator)
    loss = outs["loss_final"]
    loss.backward()
    for name, opt in optimizers.items():
        if not graph.archs[name].freeze:
            opt.step()
    return loss.detach(), outs["err_final"].detach()


def eval_step(
    graph: GraphSpec,
    feats: torch.Tensor,
    labs: torch.Tensor,
    n_valid_t: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, err) of a validation batch, every architecture in eval mode."""
    with torch.inference_mode():
        outs = apply_graph(graph, feats, labs, train=False, to_do="valid",
                           n_valid_t=n_valid_t)
        return outs["loss_final"], outs["err_final"]


def forward_step(
    graph: GraphSpec,
    feats: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    log_priors: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    pack_idx: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Posteriors for one utterance batch, each flattened to (T*B, C).

    `lengths` makes bucket-padded utterances exact for bidirectional
    models.  `log_priors` (out_name -> float32 tensor on the graph's device,
    or None) subtracts `log(counts/sum(counts))` (reference core.py:665-668)
    on the device.  `pack_idx` (N,) gathers the rows of real frames before
    the caller copies the result to the host, so padding never crosses.
    """
    with torch.inference_mode():
        outs = apply_graph(graph, feats, None, train=False, to_do="forward",
                           lengths=lengths)
        result = {}
        for name in graph.forward_outs:
            o = outs[name].float()
            prior = (log_priors or {}).get(name)
            if prior is not None:
                o = o - prior
            o = o.reshape(o.shape[0] * o.shape[1], -1) if o.ndim == 3 else o
            if pack_idx is not None:
                o = o.index_select(0, pack_idx)
            result[name] = o
    return result
