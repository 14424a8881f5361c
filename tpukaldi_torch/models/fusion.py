"""fusionRNN, the multi-microphone Li-GRU with a shared-weight fusion layer
(counterpart of `tpukaldi/models/fusion.py`; reference neural_networks.py:
719-996 fusionRNN_jit, :2057-2099 FusionLinearConv; cfg/DIRHA/
fusionRNN_mfcc_6ch.cfg).  It follows tpukaldi:

- every layer is bidirectional (batch doubling with the length-aware time
  reversal);
- layer 0, under `fusionrnn_do_fusion`, is `fusionrnn_fusion_layer_size //
  fusionrnn_number_of_mic` wide and projects with two `FusionLinear`s (wz,
  wh): ONE (Din/M, out) map applied to each of the M microphones' slices,
  an activation (`prelu` with a fixed 0.25 slope, `leaky_relu` 0.01,
  `relu`, else tanh), then summed or averaged over the microphones; every
  other layer projects with one Linear (D -> 2H, [wh | wz], with bias);
- per-gate batchnorm over the (T*B') rows;
- the recurrent weight u is (H, 2H) in [uz | uh] order;
- recurrent dropout is INVERTED, one Bernoulli(1-p) mask over 1-p shared
  across time at train, 1 at eval, unlike the other cells;
- the candidate is relu whatever `fusionrnn_act` says (tpukaldi ignores
  it).

That recurrence is the liGRU's term for term (z = sigmoid(wz + h Uz), hc =
relu(wh + h Uh) * mask, h = z h + (1 - z) hc), so it runs the port's K1
with u reordered into K1's [uh | uz] and the gates into its (wh, wz)
layout; K1's gates hold (H <= 2048 serving and H <= 1024 training, a grid
the card holds at once) and a refused launch raises.  Where no gradient is wanted (eval, forward,
serving, export) it is the `tpukaldi::fusion_recurrence` op
(`kernels/ops.py`), which chooses by device when it runs: K1f on a CUDA
tensor, on a CPU one K1's plain version (in bf16 the plain loop carrying
bf16), so an artifact traced on the CPU launches K1f on a card.
Training runs `LiGRURecurrence` (K1f forward, K1b backward) on a CUDA
tensor and `ligru_recurrence_ref` on a CPU one.

The state_dict keys follow tpukaldi's names: `fuse_wz.weight` (out, Din/M)
and `.bias`, `fuse_wh.*`, `w.{i}.weight` (2H, D) and `.bias`,
`bn_wz.{i}.*`, `bn_wh.{i}.*`, and `u.{i}` (H, 2H) as tpukaldi keeps it.

Tensor contract: x is (T, B, D) -> (T, B, 2 * H of the last layer).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import to_bool
from ..kernels import ops
from ..kernels.ligru import LiGRURecurrence, ligru_recurrence_ref
from .common import batchnorm, float_list, int_list
from .recurrent import _reverse_time

# flax's xavier_normal draws a normal truncated at 2 standard deviations,
# rescaled by this factor so that its variance is the untruncated one's
_TRUNC_STD = 0.87962566103423978


def _fusion_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("leaky_relu", "leaky"):
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "relu":
        return torch.relu
    if name == "prelu":
        # PReLU with torch's default slope 0.25, held fixed as tpukaldi does
        return lambda x: torch.where(x >= 0, x, 0.25 * x)
    return torch.tanh


def xavier_normal(shape, fan_in: int, fan_out: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's `xavier_normal`: a normal of variance 2/(fan_in + fan_out),
    truncated at two standard deviations."""
    std = (2.0 / (fan_in + fan_out)) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std,
                                 2.0 * std, generator=generator)


class FusionLinear(nn.Module):
    """Shared-weight multi-mic projection: (..., M * Din/M) -> (..., out),
    one (Din/M -> out) map applied to every mic, the activation, then the
    sum or mean over the mics (FusionLinearConv, neural_networks.py:
    2082-2097)."""

    def __init__(self, in_features: int, out_features: int,
                 number_of_mic: int, act: str = "prelu", reduce: str = "sum",
                 device=None):
        super().__init__()
        self.number_of_mic = number_of_mic
        self.per_mic = in_features // number_of_mic
        self.act = _fusion_act(act)
        self.reduce = reduce
        self.weight = nn.Parameter(
            torch.empty(out_features, self.per_mic, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            out, per_mic = self.weight.shape
            self.weight.copy_(xavier_normal((out, per_mic), per_mic, out,
                                            generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xm = x.reshape(*x.shape[:-1], self.number_of_mic, self.per_mic)
        out = self.act(xm @ self.weight.t() + self.bias)
        return out.mean(dim=-2) if self.reduce == "mean" else out.sum(dim=-2)


class fusionRNN(nn.Module):
    """Options follow the DIRHA cfg keys (lowercased by configparser):
    fusionrnn_lay, fusionrnn_drop, fusionrnn_do_fusion,
    fusionrnn_fusion_layer_size, fusionrnn_number_of_mic,
    fusionrnn_fusion_act, fusionrnn_fusion_reduce."""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o = options
        self.drop = float_list(o["fusionrnn_drop"])
        do_fusion = to_bool(o.get("fusionrnn_do_fusion", "False"))
        n_mic = int(o.get("fusionrnn_number_of_mic", 1))
        fusion_size = int(o.get("fusionrnn_fusion_layer_size", 64))
        self.hidden = []
        self.w = nn.ModuleList()
        self.bn_wz = nn.ModuleList()
        self.bn_wh = nn.ModuleList()
        self.u = nn.ParameterList()
        D = inp_dim
        for i, width in enumerate(int_list(o["fusionrnn_lay"])):
            H = fusion_size // n_mic if do_fusion and i == 0 else width
            if do_fusion and i == 0:
                args = (D, H, n_mic, o.get("fusionrnn_fusion_act", "prelu"),
                        o.get("fusionrnn_fusion_reduce", "sum"))
                self.fuse_wz = FusionLinear(*args, device=device)
                self.fuse_wh = FusionLinear(*args, device=device)
                # a placeholder keeps the layer indices, with no state
                self.w.append(nn.Identity())
            else:
                self.w.append(nn.Linear(D, 2 * H, device=device))
            self.bn_wz.append(batchnorm(H, device=device))
            self.bn_wh.append(batchnorm(H, device=device))
            self.u.append(nn.Parameter(torch.empty(H, 2 * H, device=device)))
            self.hidden.append(H)
            D = 2 * H

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        return 2 * int_list(options["fusionrnn_lay"])[-1]

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """tpukaldi's init: xavier-normal projections with zero biases, u
        orthogonal, batchnorm at its defaults."""
        with torch.no_grad():
            for i, H in enumerate(self.hidden):
                lin = self.w[i]
                if isinstance(lin, nn.Linear):
                    lin.weight.copy_(xavier_normal(
                        lin.weight.shape, lin.in_features, 2 * H, generator))
                    lin.bias.zero_()
                else:
                    self.fuse_wz.reset_parameters(generator)
                    self.fuse_wh.reset_parameters(generator)
                self.u[i].copy_(nn.init.orthogonal_(torch.empty(H, 2 * H),
                                                    generator=generator))
        for bn in (*self.bn_wz, *self.bn_wh):
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, H in enumerate(self.hidden):
            T, B, D = x.shape
            x = torch.cat([x, _reverse_time(x, lengths)], dim=1)
            Bp = x.shape[1]
            if isinstance(self.w[i], nn.Linear):
                ff = self.w[i](x.reshape(T * Bp, D))
                wh, wz = ff[:, :H], ff[:, H:]
            else:
                wz = self.fuse_wz(x).reshape(T * Bp, H)
                wh = self.fuse_wh(x).reshape(T * Bp, H)
            # K1's (wh, wz) gate layout and [uh | uz] recurrent weights
            ff = torch.cat([self.bn_wh[i](wh), self.bn_wz[i](wz)], dim=1)
            ff = ff.reshape(T, Bp, 2 * H)
            u = torch.cat([self.u[i][:, H:], self.u[i][:, :H]], dim=1)
            p = self.drop[i]
            if self.training and p > 0.0:
                mask = torch.empty((Bp, H), device=x.device).bernoulli_(
                    1.0 - p, generator=generator) / (1.0 - p)
            else:
                mask = torch.ones((), device=x.device)
            # the mask in the layer's dtype, as tpukaldi casts it (bf16 in
            # the bf16 compute mode, where its scan carries bf16 and K1
            # widens its inputs and returns float32 h)
            mask = mask.to(x.dtype)
            if not torch.is_grad_enabled():
                h = ops.fusion_recurrence(
                    ff, u.contiguous(), mask.expand(Bp, H).contiguous())
            elif x.device.type == "cpu":
                h = ligru_recurrence_ref(ff, u, mask)
            else:
                h = LiGRURecurrence.apply(
                    ff, u.contiguous(),
                    mask.expand(Bp, H).contiguous()).to(x.dtype)
            x = torch.cat([h[:, :B], _reverse_time(h[:, B:], lengths)], dim=2)
        return x


# the reference's class name (cfg arch_class = fusionRNN_jit)
fusionRNN_jit = fusionRNN
