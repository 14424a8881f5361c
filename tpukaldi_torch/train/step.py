"""The forward step over the compiled graph (counterpart of tpukaldi's
`train/step.py::make_forward_step`).  The training and eval steps are not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..graph.compiler import GraphSpec, apply_graph


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
