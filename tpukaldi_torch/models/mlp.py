"""MLP — feed-forward stack with per-layer dropout/batchnorm/laynorm toggles
(counterpart of `tpukaldi/models/mlp.py`, reference neural_networks.py:60-150).

Inputs are (N, D); the graph compiler flattens (T, B, D) callers.  The
state_dict keeps the reference layout: `wx.{i}` Linear (out, in),
`ln.{i}`/`bn.{i}` per layer, `ln0`/`bn0` on the input.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config.schema import to_bool
from .common import (
    RefLayerNorm,
    act_fun,
    batchnorm,
    bool_list,
    float_list,
    glorot_small_uniform,
    int_list,
    inverted_dropout,
)


class MLP(nn.Module):
    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o = options
        self.lay = int_list(o["dnn_lay"])
        self.drop = float_list(o["dnn_drop"])
        self.use_bn = bool_list(o["dnn_use_batchnorm"])
        self.use_ln = bool_list(o["dnn_use_laynorm"])
        self.acts = o["dnn_act"].split(",")
        if to_bool(o.get("dnn_use_laynorm_inp", "False")):
            self.ln0 = RefLayerNorm(inp_dim, device=device)
        if to_bool(o.get("dnn_use_batchnorm_inp", "False")):
            self.bn0 = batchnorm(inp_dim, device=device)
        self.wx = nn.ModuleList()
        self.ln = nn.ModuleList()
        self.bn = nn.ModuleList()
        current = inp_dim
        for i, width in enumerate(self.lay):
            use_bias = not (self.use_ln[i] or self.use_bn[i])
            self.wx.append(nn.Linear(current, width, bias=use_bias, device=device))
            # Identity placeholders keep the reference's per-layer indices
            # while adding no state_dict entries for unused norms
            self.ln.append(RefLayerNorm(width, device=device)
                           if self.use_ln[i] else nn.Identity())
            self.bn.append(batchnorm(width, device=device)
                           if self.use_bn[i] else nn.Identity())
            current = width

    @staticmethod
    def compute_out_dim(options: Dict[str, str], inp_dim: int) -> int:
        return int_list(options["dnn_lay"])[-1]

    @property
    def out_dim(self) -> int:
        return self.lay[-1]

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            current = self.inp_dim
            for lin, width in zip(self.wx, self.lay):
                lin.weight.copy_(glorot_small_uniform(
                    lin.weight.shape, current, width, generator))
                if lin.bias is not None:
                    lin.bias.zero_()
                current = width
        for m in (*self.ln, *self.bn, getattr(self, "ln0", None),
                  getattr(self, "bn0", None)):
            if isinstance(m, (RefLayerNorm, nn.BatchNorm1d)):
                m.reset_parameters()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if hasattr(self, "ln0"):
            x = self.ln0(x)
        if hasattr(self, "bn0"):
            x = self.bn0(x)
        for i in range(len(self.lay)):
            x = self.wx[i](x)
            x = self.ln[i](x)
            x = self.bn[i](x)
            x = act_fun(self.acts[i])(x)
            # torch nn.Dropout semantics (inverted), identity at eval
            # (tpukaldi/models/mlp.py:70-71); drawn on x's device
            x = inverted_dropout(x, self.drop[i], self.training, generator)
        return x
