"""Recurrent models (counterpart of `tpukaldi/models/recurrent.py`): the
shared `_RecurrentBase` scaffold, the flagship `liGRU`, `LSTM`, `GRU`,
`minimalGRU` and `RNN`.

Per layer, as in tpukaldi:
- the feed-forward gate projections run as ONE (T*B', D) @ (D, G*H) matmul;
- optional batchnorm over the (T*B') rows of each gate's projection;
- bidirectionality by doubling the batch with the (length-aware)
  time-reversed copy, split and re-reversed after the recurrence;
- recurrent dropout as one mask shared across time (train) or the scalar
  (1-p) (eval) — not inverted dropout;
- the time recurrence with one fused (B', H) @ (H, G*H) product per step
  (the GRU's candidate product on r*h apart): for the layers a cell's
  kernels take (liGRU relu, LSTM tanh, GRU relu or tanh; no laynorm) the
  hand-written kernels (`kernels/{ligru,lstm,gru}.py`: an autograd Function
  with the forward kernel, and the backward kernel as its gradient), else
  that kernel's plain Python loop, through which autograd differentiates.
  `minimalGRU` and `RNN` have no kernel (tpukaldi scans them too): they
  always run their plain loops.

Training calls pass no `lengths`, as tpukaldi's train and eval steps pass
none: the reversal is then a plain flip over the bucket-padded batch.

In the bf16 compute mode (`train/step.py`) a layer runs in bf16 as
tpukaldi's does: the projections in bf16, the batchnorm in float32 on a
widened input (`common.py::BatchNorm`), the dropout mask cast to bf16; a
kernel layer widens its bf16 inputs at the kernel's boundary, and the
float32 h the kernel returns is cast back to bf16; the plain loops carry
their state in bf16 as tpukaldi's scan does (`kernels/_launch.py::carry`).

The state_dict keeps the reference layout (neural_networks.py:300-655,
:997-1155): per-gate feed-forward Linear (out, in) (`wh.{i}`/`wz.{i}`;
LSTM `wfx/wix/wox/wcx`; GRU `wh/wz/wr`; minimalGRU `wh/wz`; RNN `wh`),
per-gate recurrent Linear without bias (`uh/uz`; `ufh/uih/uoh/uch`;
`uh/uz/ur`; `uh/uz`; `uh`), per-gate `bn_<ff gate>.{i}`,
`ln.{i}` and the input `ln0`/`bn0`.

Tensor contract: x is (T, B, D) -> (T, B, out_dim).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config.schema import to_bool
from ..kernels import ops
from ..kernels.gru import (
    GRURecurrence,
    gru_recurrence_ref,
    minimalgru_recurrence_ref,
)
from ..kernels.ligru import LiGRURecurrence, ligru_recurrence_ref
from ..kernels.lstm import LSTMRecurrence, lstm_recurrence_ref
from ..kernels.rnn import rnn_recurrence_ref
from .common import (
    RefLayerNorm,
    act_fun,
    batchnorm,
    bool_list,
    float_list,
    int_list,
    orthogonal,
    recurrent_drop_mask,
    torch_linear_uniform,
)


def _reverse_time(x: torch.Tensor, lengths: Optional[torch.Tensor]):
    """Time-reverse (T, B, D); with `lengths` only the valid frames of each
    sequence are reversed and the trailing padding stays in place.  An
    involution, so it also un-reverses the recurrence output."""
    if lengths is None:
        return torch.flip(x, dims=(0,))
    T = x.shape[0]
    t = torch.arange(T, device=x.device)[:, None]
    lengths = lengths.to(x.device)[None, :]
    idx = torch.where(t < lengths, lengths - 1 - t, t)
    return torch.gather(x, 0, idx[:, :, None].expand(-1, -1, x.shape[2]))


class _RecurrentBase(nn.Module):
    """Shared scaffold; subclasses set PREFIX and the gate attribute names
    (FF_GATES: torch attrs of the feed-forward Linears, in tpukaldi's gate
    order; REC_GATES: of the recurrent ones; FUSED_REC: those of REC_GATES
    whose weights join the one per-step product `u`, all of them unless a
    subclass says otherwise) and implement `recurrence`."""

    PREFIX = ""
    FF_GATES = ()
    REC_GATES = ()
    FUSED_REC = None  # None: all of REC_GATES

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o, p = options, self.PREFIX
        self.lay = int_list(o[f"{p}_lay"])
        self.drop = float_list(o[f"{p}_drop"])
        self.use_bn = bool_list(o[f"{p}_use_batchnorm"])
        self.use_ln = bool_list(o[f"{p}_use_laynorm"])
        self.acts = o[f"{p}_act"].split(",")
        self.bidir = to_bool(o[f"{p}_bidir"])
        self.orthinit = to_bool(o.get(f"{p}_orthinit", "True"))
        if to_bool(o.get(f"{p}_use_laynorm_inp", "False")):
            self.ln0 = RefLayerNorm(inp_dim, device=device)
        if to_bool(o.get(f"{p}_use_batchnorm_inp", "False")):
            self.bn0 = batchnorm(inp_dim, device=device)
        for g in self.FF_GATES + self.REC_GATES:
            setattr(self, g, nn.ModuleList())
        for g in self.FF_GATES:
            setattr(self, f"bn_{g}", nn.ModuleList())
        self.ln = nn.ModuleList()
        current = inp_dim
        for i, hidden in enumerate(self.lay):
            use_bias = not (self.use_ln[i] or self.use_bn[i])
            for g in self.FF_GATES:
                getattr(self, g).append(
                    nn.Linear(current, hidden, bias=use_bias, device=device))
                # Identity placeholders keep the per-layer indices without
                # adding state_dict entries for unused norms
                getattr(self, f"bn_{g}").append(
                    batchnorm(hidden, device=device)
                    if self.use_bn[i] else nn.Identity())
            for g in self.REC_GATES:
                getattr(self, g).append(
                    nn.Linear(hidden, hidden, bias=False, device=device))
            self.ln.append(RefLayerNorm(hidden, device=device)
                           if self.use_ln[i] else nn.Identity())
            current = hidden * (2 if self.bidir else 1)

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        lay = int_list(options[f"{cls.PREFIX}_lay"])
        return lay[-1] * (2 if to_bool(options[f"{cls.PREFIX}_bidir"]) else 1)

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for g in self.FF_GATES:
                for lin in getattr(self, g):
                    lin.weight.copy_(torch_linear_uniform(
                        lin.weight.shape, lin.in_features, generator))
                    if lin.bias is not None:
                        lin.bias.copy_(torch_linear_uniform(
                            lin.bias.shape, lin.in_features, generator))
            for g in self.REC_GATES:
                for lin in getattr(self, g):
                    H = lin.in_features
                    lin.weight.copy_(
                        orthogonal(H, generator) if self.orthinit
                        else torch_linear_uniform((H, H), H, generator))
        norms = [*self.ln, getattr(self, "ln0", None), getattr(self, "bn0", None)]
        for g in self.FF_GATES:
            norms += list(getattr(self, f"bn_{g}"))
        for m in norms:
            if isinstance(m, (RefLayerNorm, nn.BatchNorm1d)):
                m.reset_parameters()

    def recurrence(self, i: int, ff: torch.Tensor, u: torch.Tensor,
                   drop_mask: torch.Tensor) -> torch.Tensor:
        """(T, B', G*H) feed-forward gates, the fused recurrent weights u
        (H, len(FUSED_REC)*H) -> (T, B', H) hidden sequence.  Where no
        gradient is wanted it runs the cell's custom op
        (`kernels/ops.py`), which an exported graph holds."""
        raise NotImplementedError

    def _ln_args(self, i: int):
        """Layer i's layer norm as the ops take it: (gamma, beta, eps), or
        (None, None, 0.0) without one."""
        if not self.use_ln[i]:
            return None, None, 0.0
        ln = self.ln[i]
        return ln.gamma, ln.beta, ln.eps

    def _impl(self, i: int, kernel_acts, ff: torch.Tensor) -> str:
        """How layer i runs: "kernel" (the cell's autograd Function), "scan"
        (its plain loop at the kernel's shapes) or "loop" (the plain loop
        with any activation and optional laynorm), by `<prefix>_impl`
        (auto | pallas | scan).  `pallas` asks for the hand kernel, which
        runs on CUDA tensors only."""
        if self.acts[i] not in kernel_acts or self.use_ln[i]:
            return "loop"
        impl = self.options.get(f"{self.PREFIX}_impl", "auto")
        if impl == "scan":
            return "scan"
        if impl == "pallas" and ff.device.type == "cpu":
            raise ValueError(
                f"{self.PREFIX}_impl=pallas asks for the hand kernel, which "
                "runs on CUDA tensors only; use auto or scan on CPU")
        return "kernel"

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if hasattr(self, "ln0"):
            x = self.ln0(x)
        if hasattr(self, "bn0"):
            T0, B0, D0 = x.shape
            x = self.bn0(x.reshape(T0 * B0, D0)).reshape(T0, B0, D0)
        for i, hidden in enumerate(self.lay):
            T, B, D = x.shape
            if self.bidir:
                x = torch.cat([x, _reverse_time(x, lengths)], dim=1)
            Bp = x.shape[1]
            lins = [getattr(self, g)[i] for g in self.FF_GATES]
            # fused feed-forward projection of all gates: one matmul
            w = torch.cat([lin.weight for lin in lins], dim=0)
            ff = x.reshape(T * Bp, D) @ w.t()
            if lins[0].bias is not None:
                ff = ff + torch.cat([lin.bias for lin in lins])
            if self.use_bn[i]:
                # per-gate batchnorm over the (T*B') rows
                ff = torch.cat([
                    getattr(self, f"bn_{g}")[i](part) for g, part in
                    zip(self.FF_GATES, ff.split(hidden, dim=1))], dim=1)
            ff = ff.reshape(T, Bp, len(lins) * hidden).contiguous()
            u = torch.cat([getattr(self, g)[i].weight.t()
                           for g in self.FUSED_REC or self.REC_GATES],
                          dim=1).contiguous()
            # the mask in the layer's dtype (bf16 in the bf16 compute mode),
            # as tpukaldi casts it: the plain loops then carry their state
            # in that dtype, and the kernels widen it at their boundary
            drop_mask = recurrent_drop_mask(
                self.training, (Bp, hidden), self.drop[i], ff.device,
                generator).to(ff.dtype)
            h = self.recurrence(i, ff, u, drop_mask)
            if self.bidir:
                h = torch.cat([h[:, :B], _reverse_time(h[:, B:], lengths)], dim=2)
            x = h
        return x


class liGRU(_RecurrentBase):
    """Light GRU (the flagship cell): single update gate, relu candidate,
    batchnorm on the feed-forward path.

    `ligru_impl`: `auto`/`pallas` run relu/no-laynorm layers through the
    hand kernels, forward and backward (their plain versions on CPU
    tensors; `pallas` refuses CPU tensors), `scan` through the plain loop
    and autograd."""

    PREFIX = "ligru"
    FF_GATES = ("wh", "wz")
    REC_GATES = ("uh", "uz")

    def recurrence(self, i, ff, u, drop_mask):
        impl = self._impl(i, ("relu",), ff)
        if not torch.is_grad_enabled():
            mask = drop_mask if impl == "loop" else drop_mask.expand(
                ff.shape[1], u.shape[0]).contiguous()
            return ops.ligru_recurrence(ff, u, mask, impl == "kernel",
                                        self.acts[i], *self._ln_args(i))
        if impl == "loop":
            # any activation, optional laynorm on h: the plain loop only
            return ligru_recurrence_ref(
                ff, u, drop_mask, act_fun(self.acts[i]),
                self.ln[i] if self.use_ln[i] else None)
        mask = drop_mask.expand(ff.shape[1], u.shape[0]).contiguous()
        if impl == "scan":
            return ligru_recurrence_ref(ff, u, mask)
        # the kernels compute and return h in float32; the layer goes on in
        # its own dtype (tpukaldi's `h.astype(ff.dtype)`)
        return LiGRURecurrence.apply(ff, u, mask).to(ff.dtype)


class LSTM(_RecurrentBase):
    """LSTM with the reference's drop-mask-on-candidate convention
    (neural_networks.py:457-469); `act` is the candidate's and the cell
    output's activation.

    `lstm_impl`: `auto`/`pallas` run tanh/no-laynorm layers through the
    hand kernels K2f/K2b (float32 at every H; tpukaldi's bf16-U lean kernel
    is the QLSTM's), `scan` through the plain loop and autograd."""

    PREFIX = "lstm"
    FF_GATES = ("wfx", "wix", "wox", "wcx")
    REC_GATES = ("ufh", "uih", "uoh", "uch")

    def recurrence(self, i, ff, u, drop_mask):
        impl = self._impl(i, ("tanh",), ff)
        if not torch.is_grad_enabled():
            mask = drop_mask if impl == "loop" else drop_mask.expand(
                ff.shape[1], u.shape[0]).contiguous()
            return ops.lstm_recurrence(ff, u, mask, impl == "kernel",
                                       self.acts[i], *self._ln_args(i))
        if impl == "loop":
            return lstm_recurrence_ref(
                ff, u, drop_mask, act_fun(self.acts[i]),
                self.ln[i] if self.use_ln[i] else None)[0]
        mask = drop_mask.expand(ff.shape[1], u.shape[0]).contiguous()
        if impl == "scan":
            return lstm_recurrence_ref(ff, u, mask)[0]
        return LSTMRecurrence.apply(ff, u, mask).to(ff.dtype)


class GRU(_RecurrentBase):
    """Standard GRU with reset gate (neural_networks.py:629-641).  The
    candidate product acts on r*h, so `uh` stays out of the fused per-step
    product of `uz`/`ur` (tpukaldi's `extra_params`).

    `gru_impl`: `auto`/`pallas` run relu or tanh no-laynorm layers through
    the hand kernels K3f/K3b, `scan` through the plain loop and autograd."""

    PREFIX = "gru"
    FF_GATES = ("wh", "wz", "wr")
    REC_GATES = ("uh", "uz", "ur")
    FUSED_REC = ("uz", "ur")

    def recurrence(self, i, ff, uzr, drop_mask):
        uh = self.uh[i].weight.t().contiguous()
        impl = self._impl(i, ("relu", "tanh"), ff)
        if not torch.is_grad_enabled():
            mask = drop_mask if impl == "loop" else drop_mask.expand(
                ff.shape[1], uzr.shape[0]).contiguous()
            return ops.gru_recurrence(ff, uzr, uh, mask, impl == "kernel",
                                      self.acts[i], *self._ln_args(i))
        if impl == "loop":
            return gru_recurrence_ref(
                ff, uzr, uh, drop_mask, act_fun(self.acts[i]),
                self.ln[i] if self.use_ln[i] else None)
        mask = drop_mask.expand(ff.shape[1], uzr.shape[0]).contiguous()
        if impl == "scan":
            return gru_recurrence_ref(ff, uzr, uh, mask, self.acts[i])
        return GRURecurrence.apply(ff, uzr, uh, mask,
                                   self.acts[i]).to(ff.dtype)


class minimalGRU(_RecurrentBase):
    """Minimal GRU (reference neural_networks.py:1158-1317): the update
    gate also gates the state inside the candidate, so, as in the GRU,
    `uh` acts on z*h and stays out of the fused per-step product (`uz`
    alone).  Any activation, optional laynorm on h: the plain loop
    (`kernels/gru.py::minimalgru_recurrence_ref`) on every device."""

    PREFIX = "minimalgru"
    FF_GATES = ("wh", "wz")
    REC_GATES = ("uh", "uz")
    FUSED_REC = ("uz",)

    def recurrence(self, i, ff, uz, drop_mask):
        if not torch.is_grad_enabled():
            return ops.minimalgru_recurrence(
                ff, uz, self.uh[i].weight.t(), drop_mask, self.acts[i],
                *self._ln_args(i))
        return minimalgru_recurrence_ref(
            ff, uz, self.uh[i].weight.t(), drop_mask, act_fun(self.acts[i]),
            self.ln[i] if self.use_ln[i] else None)


class RNN(_RecurrentBase):
    """Vanilla recurrence (reference neural_networks.py:1319-1461):
    h = act(ff + h Uh) * mask, the shared recurrent dropout mask on h
    itself.  The plain loop (`kernels/rnn.py::rnn_recurrence_ref`) on every
    device."""

    PREFIX = "rnn"
    FF_GATES = ("wh",)
    REC_GATES = ("uh",)

    def recurrence(self, i, ff, uh, drop_mask):
        if not torch.is_grad_enabled():
            return ops.rnn_recurrence(ff, uh, drop_mask, self.acts[i],
                                      *self._ln_args(i))
        return rnn_recurrence_ref(
            ff, uh, drop_mask, act_fun(self.acts[i]),
            self.ln[i] if self.use_ln[i] else None)
