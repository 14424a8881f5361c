"""The `*_cudnn` family (counterpart of `tpukaldi/models/cudnn_like.py`,
reference neural_networks.py:153-298): `LSTM_cudnn`, `GRU_cudnn` and
`RNN_cudnn`, stacks of torch's RNN cells built layer by layer, each
direction as tpukaldi's `_CudnnBase.__call__` builds it.

tpukaldi computes these classes with a `lax.scan`, no Pallas kernel, and
its cell equations are torch's own: the gate orders (i, f, g, o) and (r, z,
n), separate input and recurrent biases, and the GRU's `b_hn` inside
r * (W_hn h + b_hn).  So each layer is one call of torch's RNN
(`torch.lstm` / `gru` / `rnn_tanh` / `rnn_relu`: cuDNN on the card, with
TF32 off: `train/chunk_runtime.py::pin_float32`), both directions in it
(`rnn_layer`).

- Options (proto/{LSTM,GRU,RNN}_cudnn.proto): hidden_size, num_layers,
  bias, dropout (inverted, between layers), bidirectional, nonlinearity
  (RNN_cudnn: tanh, any other value relu, as in tpukaldi).  `batch_first`
  only switches on orthogonal init of `weight_hh` (the reference never
  passes it to the torch module): the data stay (T, B, D).
- Bidirectionality is tpukaldi's: separate weights per direction, the
  forward direction on x, the reverse one on `_reverse_time(x, lengths)`
  and its output un-reversed the same way.  Without `lengths` (training)
  that is a plain flip over the bucket-padded batch; with them each
  sequence's reverse direction starts at its last valid frame, and a row
  of length 0 (forward batches are padded with such rows) stays in place:
  its frames are padding, finite and never written.  One call still runs
  both directions: with lengths on a doubled batch, whose second half the
  reverse direction reads (`rnn_layer`).
- The inter-layer dropout is `common.py::inverted_dropout` from the
  generator the graph passes (tpukaldi's `FastDropout` between layers).
- Where no gradient is wanted (eval, forward, serving, export) a layer
  runs the `tpukaldi::cudnn_rnn_layer` custom op
  (`kernels/ops.py`), whose fake keeps T and B symbolic under
  `torch.export`; training calls `rnn_layer` itself, through autograd.
- On a card each layer keeps its float32 weights in one buffer of its own
  in cuDNN's layout (`flatten_weights`, again after every move), so a
  call copies none of them.
- In the bf16 compute mode tpukaldi's scan starts from a float32 state, so
  these layers compute and return float32 on the bf16-rounded weights;
  `rnn_layer` widens bf16 inputs and returns float32 likewise.

The state_dict is torch's own RNN keys under one `ModuleList` entry, as the
reference's wrapper holds it: `lstm.0.` (`gru.0.`, `rnn.0.`) +
`weight_ih_l{k}`, `weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}`, each
with `_reverse` for the second direction; weights (G*H, in), biases
(G*H,).  The torch module only holds them.  `compat/jax_params.py` maps
them to tpukaldi's per-layer `w_ih{k}` (2, D, G*H), `w_hh{k}` (2, H, G*H),
`b_ih{k}`, `b_hh{k}` (2, G*H).

Tensor contract: x is (T, B, D) -> (T, B, H * (2 if bidirectional)).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..config.schema import to_bool
from ..kernels import ops
from ..kernels._launch import widen
from .common import inverted_dropout, torch_linear_uniform
from .recurrent import _reverse_time

# torch's RNN mode -> its function
CELLS = {"LSTM": torch.lstm, "GRU": torch.gru, "RNN_TANH": torch.rnn_tanh,
         "RNN_RELU": torch.rnn_relu}


def rnn_layer(x: torch.Tensor, lengths: Optional[torch.Tensor],
              weights: List[torch.Tensor], has_bias: bool, mode: str,
              bidirectional: bool, train: bool) -> torch.Tensor:
    """One layer, both directions under `bidirectional`, in one call of
    torch's RNN (cuDNN runs the two directions at once): (T, B, D) -> (T,
    B, H or 2H), from a zero state.  `weights` are the layer's in torch's
    order, (w_ih, w_hh) and with `has_bias` (b_ih, b_hh), the forward
    direction's first.  The reverse direction runs on `_reverse_time(x,
    lengths)` and its output is un-reversed the same way.  Without
    `lengths` that is the time flip torch's bidirectional call makes
    itself; with them the batch is doubled, its second half that reversal
    flipped back in time, so that torch's reverse direction reads each
    row's reversal from its first frame, and each direction keeps its own
    half.  bf16 inputs are widened to float32 (the bf16 compute mode's
    rule), so h is float32 (float64 on float64 inputs); `train` keeps
    what cuDNN's backward needs."""
    x = widen(x)
    weights = [widen(w) for w in weights]
    B, H = x.shape[1], weights[1].shape[1]
    if bidirectional and lengths is not None:
        x = torch.cat([x, _reverse_time(x, lengths).flip(0)], dim=1)
    h0 = x.new_zeros((2 if bidirectional else 1, x.shape[1], H))
    hx = (h0, h0) if mode == "LSTM" else h0
    h = CELLS[mode](x, hx, weights, has_bias, 1, 0.0, train, bidirectional,
                    False)[0]
    if not bidirectional or lengths is None:
        return h
    return torch.cat([h[:, :B, :H],
                      _reverse_time(h[:, B:, H:].flip(0), lengths)], dim=2)


class _CudnnBase(nn.Module):
    """Subclasses set RNN (the torch module class that holds the weights)
    and ATTR (its ModuleList's name in the state_dict)."""

    RNN = nn.RNN
    ATTR = ""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o = options
        self.hidden = int(o["hidden_size"])
        self.num_layers = int(o["num_layers"])
        self.bias = to_bool(o.get("bias", "True"))
        self.dropout = float(o.get("dropout", 0.0))
        self.bidir = to_bool(o.get("bidirectional", "False"))
        self.ortho_hh = to_bool(o.get("batch_first", "False"))
        kwargs = dict(num_layers=self.num_layers, bias=self.bias,
                      bidirectional=self.bidir, device=device)
        if self.RNN is nn.RNN:
            # tpukaldi takes any value but tanh as relu
            kwargs["nonlinearity"] = ("tanh" if o.get("nonlinearity", "tanh")
                                      == "tanh" else "relu")
        setattr(self, self.ATTR, nn.ModuleList(
            [self.RNN(inp_dim, self.hidden, **kwargs)]))
        self.mode = self.torch_rnn().mode
        self.flatten_weights()

    def _apply(self, fn, recurse=True):
        # the torch module flattens its weights into one buffer when moved;
        # split them again per layer
        ret = super()._apply(fn, recurse)
        self.flatten_weights()
        return ret

    def _weights(self, layer: int) -> List[torch.Tensor]:
        """Layer `layer`'s weights in torch's order: per direction (w_ih,
        w_hh) and with `bias` (b_ih, b_hh), the forward direction's first."""
        rnn = self.torch_rnn()
        kinds = ("weight", "bias") if self.bias else ("weight",)
        return [getattr(rnn, f"{kind}_{k}_l{layer}{suffix}")
                for suffix in ("", "_reverse")[:2 if self.bidir else 1]
                for kind in kinds for k in ("ih", "hh")]

    def flatten_weights(self) -> None:
        """On a card, each layer's float32 weights become views of one
        buffer of their own in cuDNN's layout, so each call takes them as
        they are (cuDNN compacts weights that are not, on every call).  The
        parameters stay the same objects; elsewhere a no-op."""
        w = self.torch_rnn().weight_ih_l0
        if not (w.is_cuda and w.dtype == torch.float32
                and torch._use_cudnn_rnn_flatten_weight()):
            return
        from torch.backends.cudnn import rnn as cudnn_rnn

        mode = cudnn_rnn.get_cudnn_mode(self.mode)
        with torch.no_grad(), torch.cuda.device_of(w):
            for layer in range(self.num_layers):
                weights = self._weights(layer)
                torch._cudnn_rnn_flatten_weight(
                    weights, 4 if self.bias else 2, weights[0].shape[1], mode,
                    self.hidden, 0, 1, False, self.bidir)

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        hidden = int(options["hidden_size"])
        return hidden * (2 if to_bool(options.get("bidirectional", "False"))
                         else 1)

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def torch_rnn(self) -> nn.Module:
        """The torch RNN module that holds the weights."""
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
        for layer in range(self.num_layers):
            args = (x, lengths, self._weights(layer), self.bias, self.mode,
                    self.bidir)
            if torch.is_grad_enabled():
                x = rnn_layer(*args, True)
            else:
                x = ops.cudnn_rnn_layer(*args)
            if layer < self.num_layers - 1:
                x = inverted_dropout(x, self.dropout, self.training, generator)
        return x


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
