"""The `*_cudnn` family (counterpart of `tpukaldi/models/cudnn_like.py`,
reference neural_networks.py:153-298): `LSTM_cudnn`, `GRU_cudnn` and
`RNN_cudnn`, each one `torch.nn.LSTM` / `GRU` / `RNN` over all
`num_layers`, as the reference's thin wrappers are.

tpukaldi computes these classes with a `lax.scan`, no Pallas kernel, and
its cell equations are torch's own: the gate orders (i, f, g, o) and (r, z,
n), separate input and recurrent biases, and the GRU's `b_hn` inside
r * (W_hn h + b_hn).  So the port calls torch's RNN modules (cuDNN on the
card, with TF32 off: `train/chunk_runtime.py::pin_float32`).

- Options (proto/{LSTM,GRU,RNN}_cudnn.proto): hidden_size, num_layers,
  bias, dropout (inverted, between layers, as torch's), bidirectional,
  nonlinearity (RNN_cudnn: tanh or relu).  `batch_first` only switches on
  orthogonal init of `weight_hh` (the reference never passes it to the
  torch module): the data stay (T, B, D).
- Bidirectionality is torch's: separate weights per direction.  Without
  `lengths` (training) the reverse direction runs over the whole
  bucket-padded batch, as tpukaldi's plain flip does.  With `lengths` a
  bidirectional stack runs on `pack_padded_sequence(enforce_sorted=False)`,
  so each sequence's reverse direction starts at its last valid frame, as
  tpukaldi's length-aware reversal does; the valid frames agree with
  tpukaldi's and the padding frames come out as zeros.
- cuDNN's inter-layer dropout draws from the device's default generator,
  not from the generator the graph passes.
- In the bf16 compute mode tpukaldi's scan starts from a float32 state, so
  these layers compute and return float32 on the bf16-rounded weights; so
  does the port (torch's module in float32 on the widened weights).

The state_dict is torch's own RNN keys under one `ModuleList` entry, as the
reference's wrapper holds it: `lstm.0.` (`gru.0.`, `rnn.0.`) +
`weight_ih_l{k}`, `weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}`, each
with `_reverse` for the second direction; weights (G*H, in), biases
(G*H,).  `compat/jax_params.py` maps them to tpukaldi's per-layer
`w_ih{k}` (2, D, G*H), `w_hh{k}` (2, H, G*H), `b_ih{k}`, `b_hh{k}` (2,
G*H).

Tensor contract: x is (T, B, D) -> (T, B, H * (2 if bidirectional)).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..config.schema import to_bool
from .common import torch_linear_uniform


class _CudnnBase(nn.Module):
    """Subclasses set RNN (the torch module class) and ATTR (its
    ModuleList's name in the state_dict)."""

    RNN = nn.RNN
    ATTR = ""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o = options
        self.hidden = int(o["hidden_size"])
        self.bidir = to_bool(o.get("bidirectional", "False"))
        self.ortho_hh = to_bool(o.get("batch_first", "False"))
        kwargs = dict(num_layers=int(o["num_layers"]),
                      bias=to_bool(o.get("bias", "True")),
                      dropout=float(o.get("dropout", 0.0)),
                      bidirectional=self.bidir, device=device)
        if self.RNN is nn.RNN:
            # tpukaldi takes any value but tanh as relu
            kwargs["nonlinearity"] = ("tanh" if o.get("nonlinearity", "tanh")
                                      == "tanh" else "relu")
        setattr(self, self.ATTR, nn.ModuleList(
            [self.RNN(inp_dim, self.hidden, **kwargs)]))

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        hidden = int(options["hidden_size"])
        return hidden * (2 if to_bool(options.get("bidirectional", "False"))
                         else 1)

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def torch_rnn(self) -> nn.Module:
        """The one torch RNN module."""
        return self._modules[self.ATTR][0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """tpukaldi's init: U(+-1/sqrt(H)) on every weight and bias, and
        under `batch_first` each layer's recurrent weights orthogonal as
        tpukaldi draws its (K, H, G*H) parameter: one (K*H, G*H) orthogonal
        matrix, direction k its rows k*H to (k+1)*H (torch keeps each
        direction's transpose)."""
        H = self.hidden
        rnn = self.torch_rnn()
        K = 2 if self.bidir else 1
        with torch.no_grad():
            for name, p in rnn.named_parameters():
                if not (name.startswith("weight_hh") and self.ortho_hh):
                    p.copy_(torch_linear_uniform(p.shape, H, generator))
                elif not name.endswith("_reverse"):
                    q = nn.init.orthogonal_(torch.empty(K * H, p.shape[0]),
                                            generator=generator)
                    for k in range(K):
                        getattr(rnn, name + ("", "_reverse")[k]).copy_(
                            q[k * H:(k + 1) * H].t())

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rnn = self.torch_rnn()
        if x.dtype == torch.bfloat16:
            # the bf16 compute mode: tpukaldi's scan starts these cells from a
            # float32 state, which promotes every step and the layer's output
            # to float32, its bf16 weights widened; so torch's module runs in
            # float32 on the widened (bf16-rounded) weights
            weights = {n: p.float() for n, p in rnn.named_parameters()}
            x = x.float()

            def run(inp):
                return functional_call(rnn, weights, (inp,))
        else:
            run = rnn
        if lengths is None or not self.bidir:
            return run(x)[0]
        packed = pack_padded_sequence(x, lengths.cpu(), enforce_sorted=False)
        return pad_packed_sequence(run(packed)[0],
                                   total_length=x.shape[0])[0]


class LSTM_cudnn(_CudnnBase):
    """Standard LSTM, torch's gate order (i, f, g, o)."""

    RNN = nn.LSTM
    ATTR = "lstm"


class GRU_cudnn(_CudnnBase):
    """Standard GRU, torch's gate order (r, z, n), b_hn inside the reset."""

    RNN = nn.GRU
    ATTR = "gru"


class RNN_cudnn(_CudnnBase):
    """Elman RNN, tanh or relu (`nonlinearity`)."""

    RNN = nn.RNN
    ATTR = "rnn"
