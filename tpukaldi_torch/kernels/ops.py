"""The serving entries as `torch.library` custom ops (namespace `tpukaldi`).

`torch.export` cannot trace a ctypes launch, and cannot unroll a Python
loop over a symbolic time axis.  tpukaldi avoids both by forcing its
recurrences to `lax.scan` for an export (`tools/export_model.py:91-96`);
the port wraps each forward entry that a served model reaches in an op
whose fake implementation gives its output shape from the symbolic T and
B, so an exported graph holds one node per recurrence or fused conv layer:

- `ligru_recurrence`, `lstm_recurrence`, `gru_recurrence`: with `kernel`,
  the hand kernel's wrapper (K1f, K2f, K3f on a CUDA tensor, their plain
  versions on a CPU one, float32 at the boundary as the autograd Functions
  widen), else the cell's plain loop in the input's dtype with any
  activation and an optional layer norm on h (`gamma`, `beta`, `eps`);
- `lstm_recurrence_lean`: the QLSTM's recurrence, K4f on a card (bf16 ff
  taken as it is), chosen by device where the op runs;
- `fusion_recurrence`: fusionRNN's relu recurrence, K1f on a card, chosen
  by device where the op runs;
- `conv_pool`, `conv_pool_ln_act`: K5f and K6f at eval (no argmax, no
  statistics, no dropout);
- `rnn_recurrence`, `minimalgru_recurrence`, `sru_recurrence`: the zoo's
  plain loops, on either device (tpukaldi scans them too);
- `cudnn_rnn_layer`: one layer of the `*_cudnn` family, both directions
  (`models/cudnn_like.py::rnn_layer`: torch's RNN, cuDNN on a CUDA tensor;
  tpukaldi scans it, with no Pallas kernel), its length-aware reversal
  inside, bf16 widened to float32.

The models call these ops where no gradient is wanted (eval, forward,
serving and export alike), so an artifact and the live forward run the same
op; training keeps the autograd Functions.  Each implementation is what
the model ran before: on a CUDA tensor a hand kernel launches (and counts
its launch) or raises.  `load_exported` imports this module before it
loads an artifact, whose graph names the ops.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..models.common import act_fun, ref_laynorm
from . import conv1d, gru, ligru, lstm, rnn
from ._launch import widen


def _act(name: str):
    return F.selu if name == "selu" else act_fun(name)


def _ln(gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
        eps: float):
    if gamma is None:
        return None
    return lambda h: ref_laynorm(h, gamma, beta, eps)


def _hidden_like(ff: torch.Tensor, gates: int) -> torch.Tensor:
    """The fake h of a (T, B, gates * H) input."""
    return ff.new_empty((ff.shape[0], ff.shape[1], ff.shape[2] // gates))


@torch.library.custom_op("tpukaldi::ligru_recurrence", mutates_args=())
def ligru_recurrence(ff: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
                     kernel: bool, act: str, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    if kernel:
        return ligru.ligru_recurrence(widen(ff), widen(u),
                                      widen(mask)).to(ff.dtype)
    return ligru.ligru_recurrence_ref(ff, u, mask, _act(act),
                                      _ln(gamma, beta, eps))


@ligru_recurrence.register_fake
def _(ff, u, mask, kernel, act, gamma, beta, eps):
    return _hidden_like(ff, 2)


@torch.library.custom_op("tpukaldi::lstm_recurrence", mutates_args=())
def lstm_recurrence(ff: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
                    kernel: bool, act: str, gamma: Optional[torch.Tensor],
                    beta: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    if kernel:
        return lstm.lstm_recurrence(widen(ff), widen(u),
                                    widen(mask))[0].to(ff.dtype)
    return lstm.lstm_recurrence_ref(ff, u, mask, _act(act),
                                    _ln(gamma, beta, eps))[0]


@lstm_recurrence.register_fake
def _(ff, u, mask, kernel, act, gamma, beta, eps):
    return _hidden_like(ff, 4)


@torch.library.custom_op("tpukaldi::lstm_recurrence_lean", mutates_args=())
def lstm_recurrence_lean(ff: torch.Tensor, u: torch.Tensor,
                         mask: torch.Tensor, impl: str) -> torch.Tensor:
    """The QLSTM's tanh recurrence by its `qlstm_impl`, chosen on the
    tensor's device when the op runs (so an artifact exported on the CPU
    takes K4f on a card): the lean recurrence (K4f on a CUDA tensor, its
    plain version on a CPU one) under pallas, or auto on a card; else the
    float32 LSTM's entry (K2f or its plain version), or in bf16 the plain
    loop carrying bf16."""
    if impl == "pallas" or (impl == "auto" and ff.device.type == "cuda"):
        return lstm.lstm_recurrence_lean(ff, widen(u), widen(mask))[0].to(
            ff.dtype)
    if ff.dtype == torch.bfloat16:
        return lstm.lstm_recurrence_ref(ff, u, mask)[0]
    return lstm.lstm_recurrence(ff, u, mask)[0]


@lstm_recurrence_lean.register_fake
def _(ff, u, mask, impl):
    return _hidden_like(ff, 4)


def _fusion_on_k1(ff: torch.Tensor) -> bool:
    """Whether fusionRNN's recurrence takes K1's wrapper for `ff`: on a card
    always, on the CPU unless the state is carried in bf16."""
    return ff.device.type == "cuda" or ff.dtype != torch.bfloat16


@torch.library.custom_op("tpukaldi::fusion_recurrence", mutates_args=())
def fusion_recurrence(ff: torch.Tensor, u: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """fusionRNN's relu recurrence, chosen on the tensor's device when the op
    runs (so an artifact traced on the CPU launches K1f on a card): K1's
    wrapper (K1f on a CUDA tensor, its plain version on a float32 CPU one,
    float32 at the boundary), or in bf16 on the CPU the plain loop carrying
    bf16, as tpukaldi's scan does."""
    if _fusion_on_k1(ff):
        return ligru.ligru_recurrence(widen(ff), widen(u),
                                      widen(mask)).to(ff.dtype)
    return ligru.ligru_recurrence_ref(ff, u, mask)


@fusion_recurrence.register_fake
def _(ff, u, mask):
    return _hidden_like(ff, 2)


@torch.library.custom_op("tpukaldi::gru_recurrence", mutates_args=())
def gru_recurrence(ff: torch.Tensor, uzr: torch.Tensor, uh: torch.Tensor,
                   mask: torch.Tensor, kernel: bool, act: str,
                   gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                   eps: float) -> torch.Tensor:
    if kernel:
        return gru.gru_recurrence(widen(ff), widen(uzr), widen(uh),
                                  widen(mask), act).to(ff.dtype)
    return gru.gru_recurrence_ref(ff, uzr, uh, mask, _act(act),
                                  _ln(gamma, beta, eps))


@gru_recurrence.register_fake
def _(ff, uzr, uh, mask, kernel, act, gamma, beta, eps):
    return _hidden_like(ff, 3)


@torch.library.custom_op("tpukaldi::minimalgru_recurrence", mutates_args=())
def minimalgru_recurrence(ff: torch.Tensor, uz: torch.Tensor, uh: torch.Tensor,
                          mask: torch.Tensor, act: str,
                          gamma: Optional[torch.Tensor],
                          beta: Optional[torch.Tensor],
                          eps: float) -> torch.Tensor:
    return gru.minimalgru_recurrence_ref(ff, uz, uh, mask, _act(act),
                                         _ln(gamma, beta, eps))


@minimalgru_recurrence.register_fake
def _(ff, uz, uh, mask, act, gamma, beta, eps):
    return _hidden_like(ff, 2)


@torch.library.custom_op("tpukaldi::rnn_recurrence", mutates_args=())
def rnn_recurrence(ff: torch.Tensor, uh: torch.Tensor, mask: torch.Tensor,
                   act: str, gamma: Optional[torch.Tensor],
                   beta: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    return rnn.rnn_recurrence_ref(ff, uh, mask, _act(act),
                                  _ln(gamma, beta, eps))


@rnn_recurrence.register_fake
def _(ff, uh, mask, act, gamma, beta, eps):
    return _hidden_like(ff, 1)


@torch.library.custom_op("tpukaldi::sru_recurrence", mutates_args=())
def sru_recurrence(u: torch.Tensor, wf: torch.Tensor, wr: torch.Tensor,
                   x_skip: Optional[torch.Tensor], vf: torch.Tensor,
                   vr: torch.Tensor, bf: torch.Tensor, br: torch.Tensor,
                   act: str, alpha: float) -> torch.Tensor:
    from ..models.sru import sru_recurrence_ref

    return sru_recurrence_ref(u, wf, wr, x_skip, vf, vr, bf, br, _act(act),
                              alpha)


@sru_recurrence.register_fake
def _(u, wf, wr, x_skip, vf, vr, bf, br, act, alpha):
    return torch.empty_like(u)


@torch.library.custom_op("tpukaldi::conv_pool", mutates_args=())
def conv_pool(x: torch.Tensor, w: torch.Tensor, pool: int) -> torch.Tensor:
    # contiguous, as the kernel writes it (the plain version's is a view)
    return conv1d.conv1d_pool(widen(x), widen(w), pool,
                              need_idx=False)[0].to(x.dtype).contiguous()


@conv_pool.register_fake
def _(x, w, pool):
    # the envelope's check, so that an export outside it raises as a call
    _, _, _, O, M = conv1d._geometry("conv_pool", x, w, pool)
    return x.new_empty((x.shape[0], M, O))


@torch.library.custom_op("tpukaldi::conv_pool_ln_act", mutates_args=())
def conv_pool_ln_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     gt: torch.Tensor, bt: torch.Tensor, pool: int,
                     eps: float, relu: bool) -> torch.Tensor:
    dtype = x.dtype
    x, w, bias, gt, bt = (widen(t) for t in (x, w, bias, gt, bt))
    return conv1d.conv1d_pool_ln_act(x, w, bias, gt, bt, 0, pool, eps, relu,
                                     0.0, residuals=False)[0].to(
                                         dtype).contiguous()


@conv_pool_ln_act.register_fake
def _(x, w, bias, gt, bt, pool, eps, relu):
    _, _, _, O, M = conv1d._geometry("conv_pool_ln_act", x, w, pool)
    return x.new_empty((x.shape[0], M, O))


@torch.library.custom_op("tpukaldi::cudnn_rnn_layer", mutates_args=())
def cudnn_rnn_layer(x: torch.Tensor, lengths: Optional[torch.Tensor],
                    weights: List[torch.Tensor], has_bias: bool, mode: str,
                    bidirectional: bool) -> torch.Tensor:
    from ..models.cudnn_like import rnn_layer

    return rnn_layer(x, lengths, weights, has_bias, mode, bidirectional,
                     False)


@cudnn_rnn_layer.register_fake
def _(x, lengths, weights, has_bias, mode, bidirectional):
    H = weights[1].shape[1] * (2 if bidirectional else 1)
    return x.new_empty((x.shape[0], x.shape[1], H),
                       dtype=torch.float32 if x.dtype == torch.bfloat16
                       else x.dtype)
