"""SRU, the Simple Recurrent Unit (counterpart of `tpukaldi/models/sru.py`;
the reference wraps the external `sru` package, neural_networks.py:
1973-2021).  It follows tpukaldi, not that package:

  f_t = sigmoid(W_f x_t + v_f * c_{t-1} + b_f)
  c_t = f_t * c_{t-1} + (1 - f_t) * (W x_t)
  r_t = sigmoid(W_r x_t + v_r * c_{t-1} + b_r)
  h_t = r_t * g(c_t) + (1 - r_t) * x'_t * alpha   (the highway skip)

- Every matmul is feed-forward: one (T*B', D) @ (D, 3H) product a layer,
  or (D, 4H) where the skip is projected (`sru_has_skip_term` and D != H:
  the fourth block gives x'); the recurrence is elementwise, a plain loop
  over T (`sru_recurrence_ref`) on every device.
- Bidirectional by batch doubling with the length-aware time reversal, one
  shared weight `w{l}` for both directions.
- `sru_highway_bias` initialises b_r (b_f, v_f, v_r start at zero);
  alpha = (1 + 2 e^{highway_bias})^0.5 under `sru_rescale`, else 1.
- g is relu (`sru_use_relu`), selu (`sru_use_selu`), tanh (`sru_use_tanh`,
  the default) or, with all three False, the identity.
- Inverted dropout: `sru_rnn_dropout` on every layer's input and
  `sru_dropout` after every layer, the last included.
- `sru_layer_norm` applies the reference layer norm to each layer's input.

The state_dict keys are tpukaldi's parameter names, the reference's layout
being the external package's: `w{l}` (D, nH), `vf{l}`, `vr{l}`, `bf{l}`,
`br{l}` (H,) and `ln{l}.gamma`/`.beta`.

Tensor contract: x is (T, B, D) -> (T, B, H * (2 if bidirectional)).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import to_bool
from ..kernels import _launch, ops
from .common import RefLayerNorm, inverted_dropout, torch_linear_uniform, widen
from .recurrent import _reverse_time


def sru_recurrence_ref(
    u: torch.Tensor, wf: torch.Tensor, wr: torch.Tensor,
    x_skip: Optional[torch.Tensor], vf: torch.Tensor, vr: torch.Tensor,
    bf: torch.Tensor, br: torch.Tensor,
    g: Callable[[torch.Tensor], torch.Tensor], alpha: float,
) -> torch.Tensor:
    """u, wf, wr (T, B, H) (and x_skip, or None without the skip term) ->
    h (T, B, H), c_0 = 0: tpukaldi's scan step, a plain loop.  bf16 inputs
    (the bf16 compute mode) carry a bf16 c (`kernels/_launch.py::carry`)
    and give bf16 h."""
    dtype = u.dtype
    keep = _launch.carry(dtype)
    u, wf, wr, vf, vr, bf, br = (widen(t) for t in (u, wf, wr, vf, vr, bf,
                                                      br))
    x_skip = None if x_skip is None else widen(x_skip)
    c = u.new_zeros(u.shape[1:])
    out = []
    for t in range(u.shape[0]):
        f = torch.sigmoid(wf[t] + vf * c + bf)
        c = keep(f * c + (1.0 - f) * u[t])
        r = torch.sigmoid(wr[t] + vr * c + br)
        h = r * g(c)
        if x_skip is not None:
            h = h + (1.0 - r) * x_skip[t] * alpha
        out.append(keep(h))
    return torch.stack(out).to(dtype)


class SRU(nn.Module):
    """Options follow proto/SRU.proto (sru_hidden_size, sru_num_layers,
    sru_dropout, sru_rnn_dropout, sru_use_tanh/relu/selu,
    sru_bidirectional, sru_has_skip_term, sru_highway_bias, sru_rescale,
    sru_layer_norm)."""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o = options
        self.hidden = H = int(o["sru_hidden_size"])
        self.n_layers = int(o["sru_num_layers"])
        self.dropout = float(o.get("sru_dropout", 0.0))
        self.rnn_dropout = float(o.get("sru_rnn_dropout", 0.0))
        self.bidir = to_bool(o.get("sru_bidirectional", "False"))
        self.skip = to_bool(o.get("sru_has_skip_term", "True"))
        self.layer_norm = to_bool(o.get("sru_layer_norm", "False"))
        self.highway_bias = float(o.get("sru_highway_bias", 0.0))
        self.alpha = (math.sqrt(1.0 + math.exp(self.highway_bias) * 2.0)
                      if to_bool(o.get("sru_rescale", "True")) else 1.0)
        if to_bool(o.get("sru_use_relu", "False")):
            self.g, self.g_name = torch.relu, "relu"
        elif to_bool(o.get("sru_use_selu", "False")):
            self.g, self.g_name = F.selu, "selu"
        elif to_bool(o.get("sru_use_tanh", "True")):
            self.g, self.g_name = torch.tanh, "tanh"
        else:
            self.g, self.g_name = (lambda v: v), "linear"
        D = inp_dim
        for l in range(self.n_layers):
            if self.layer_norm:
                setattr(self, f"ln{l}", RefLayerNorm(D, device=device))
            # the projected skip's fourth block where the widths differ
            n_blocks = 4 if self.skip and D != H else 3
            setattr(self, f"w{l}", nn.Parameter(
                torch.empty(D, n_blocks * H, device=device)))
            for v in ("vf", "vr", "bf", "br"):
                setattr(self, f"{v}{l}",
                        nn.Parameter(torch.empty(H, device=device)))
            D = H * (2 if self.bidir else 1)

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        hidden = int(options["sru_hidden_size"])
        return hidden * (2 if to_bool(options.get("sru_bidirectional",
                                                  "False")) else 1)

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """tpukaldi's init: w U(+-1/sqrt(D)), v_f, v_r, b_f zero, b_r the
        highway bias."""
        with torch.no_grad():
            for l in range(self.n_layers):
                w = getattr(self, f"w{l}")
                w.copy_(torch_linear_uniform(w.shape, w.shape[0], generator))
                for v in ("vf", "vr", "bf"):
                    getattr(self, f"{v}{l}").zero_()
                getattr(self, f"br{l}").fill_(self.highway_bias)
                if self.layer_norm:
                    getattr(self, f"ln{l}").reset_parameters()

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H = self.hidden
        for l in range(self.n_layers):
            T, B, D = x.shape
            if self.layer_norm:
                x = getattr(self, f"ln{l}")(x)
            x = inverted_dropout(x, self.rnn_dropout, self.training, generator)
            if self.bidir:
                x = torch.cat([x, _reverse_time(x, lengths)], dim=1)
            Bp = x.shape[1]
            w = getattr(self, f"w{l}")
            ff = (x.reshape(T * Bp, D) @ w).reshape(T, Bp, w.shape[1])
            x_skip = None
            if self.skip:
                x_skip = ff[..., 3 * H:] if w.shape[1] == 4 * H else x
            args = (ff[..., :H], ff[..., H:2 * H], ff[..., 2 * H:3 * H],
                    x_skip, getattr(self, f"vf{l}"), getattr(self, f"vr{l}"),
                    getattr(self, f"bf{l}"), getattr(self, f"br{l}"))
            # the custom op (kernels/ops.py) where no gradient is wanted
            h = (sru_recurrence_ref(*args, self.g, self.alpha)
                 if torch.is_grad_enabled() else
                 ops.sru_recurrence(*args, self.g_name, self.alpha))
            if self.bidir:
                h = torch.cat([h[:, :B], _reverse_time(h[:, B:], lengths)],
                              dim=2)
            x = inverted_dropout(h, self.dropout, self.training, generator)
        return x
