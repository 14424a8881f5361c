"""LSTM recurrence: the hand-written CUDA kernels, forward and backward,
and their plain PyTorch versions.

    r    = h @ U                  # U = [Uf | Ui | Uo | Uc], (H, 4H)
    f, i, o = sigmoid(ff_{f,i,o} + r_{f,i,o})
    c_t  = i * tanh(ff_c + r_c) * mask + f * c
    h_t  = o * tanh(c_t),         h_0 = c_0 = 0

`LSTMRecurrence` is the counterpart of tpukaldi's
`kernels/lstm.py::lstm_recurrence` (a `jax.custom_vjp`): its forward is
`lstm_recurrence` and saves (ff, u, mask, h, c); its backward is
`lstm_recurrence_bwd`.  On a CUDA tensor those launch `csrc/lstm_fwd.cu`
and `csrc/lstm_bwd.cu` (design notes there) or raise; on a CPU tensor they
run `lstm_recurrence_ref` and `lstm_recurrence_bwd_ref`, the Python time
loops that mirror tpukaldi's `lstm_recurrence_scan` and `_bwd_scan`.

tpukaldi's bf16-U "lean" variant (K4, `lstm_recurrence_lean`) belongs to
the QLSTM; the port's LSTM runs this float32 recurrence at every H, which is
what tpukaldi computes off a TPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _launch

SOURCE = "lstm_fwd.cu"
BWD_SOURCE = "lstm_bwd.cu"

# kernel launches since the last reset (one per wrapper call that launched);
# chip_smoke.py reads them to show that the main path went through the
# kernels
launches = 0
bwd_launches = 0


def lstm_recurrence_ref(
    ff: torch.Tensor,
    u: torch.Tensor,
    mask: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ff (T, B, 4H), u (H, 4H), mask (B, H) or broadcastable -> (h, c),
    each (T, B, H).

    With the defaults it is the kernel's computation.  `act` (the candidate's
    and the cell output's activation) and `ln` (a layer norm applied to each
    h_t, which the next step then reads; c is carried as it is, tpukaldi's
    `LSTM.replace_output`) cover the layers the kernel does not take."""
    H = ff.shape[-1] // 4
    h = ff.new_zeros((ff.shape[1], H))
    c = ff.new_zeros((ff.shape[1], H))
    hs, cs = [], []
    for ff_t in ff:
        a = ff_t + h @ u
        f = torch.sigmoid(a[:, :H])
        i = torch.sigmoid(a[:, H:2 * H])
        o = torch.sigmoid(a[:, 2 * H:3 * H])
        c = i * act(a[:, 3 * H:]) * mask + f * c
        h = o * act(c)
        if ln is not None:
            h = ln(h)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_recurrence_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's computation as a reverse-time loop (tpukaldi's
    `_bwd_scan`): ff, h and c (the forward's outputs), g = dL/dh, u, mask
    (B, H) -> (dff (T, B, 4H), du (H, 4H), dmask (B, H))."""
    T, B, H4 = ff.shape
    H = H4 // 4
    zeros = h.new_zeros((1, B, H))
    h_prev = torch.cat([zeros, h[:-1]])
    c_prev = torch.cat([zeros, c[:-1]])
    a = ff + (h_prev.reshape(T * B, H) @ u).reshape(T, B, H4)
    f = torch.sigmoid(a[..., :H])
    i = torch.sigmoid(a[..., H:2 * H])
    o = torch.sigmoid(a[..., 2 * H:3 * H])
    cand = torch.tanh(a[..., 3 * H:])
    tanh_c = torch.tanh(c)
    ut = u.t()
    dff = ff.new_empty((T, B, H4))
    dmask = ff.new_zeros((B, H))
    dh = ff.new_zeros((B, H))
    dc = ff.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        gh = g[t] + dh
        dff[t, :, 2 * H:3 * H] = gh * tanh_c[t] * o[t] * (1.0 - o[t])
        dc = gh * o[t] * (1.0 - tanh_c[t] ** 2) + dc
        dff[t, :, :H] = dc * c_prev[t] * f[t] * (1.0 - f[t])
        dff[t, :, H:2 * H] = dc * cand[t] * mask * i[t] * (1.0 - i[t])
        dff[t, :, 3 * H:] = dc * i[t] * mask * (1.0 - cand[t] ** 2)
        dmask = dmask + dc * i[t] * cand[t]
        dh = dff[t] @ ut
        dc = dc * f[t]
    du = h_prev.reshape(T * B, H).t() @ dff.reshape(T * B, H4)
    return dff, du, dmask


def lstm_recurrence(ff: torch.Tensor, u: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (h, c): launch the CUDA kernel on a CUDA tensor; the plain
    version on CPU.  Builds no autograd graph of its own: `LSTMRecurrence`
    is the differentiable entry."""
    global launches
    if ff.device.type == "cpu":
        return lstm_recurrence_ref(ff, u, mask)
    entry, max_hidden = _launch.bind(SOURCE, "lstm_fwd", 5, 3)
    T, B, H = _launch.dims("lstm_recurrence", ff, 4)
    _launch.check_inputs("lstm_recurrence", H, max_hidden,
                         ff=(ff, (T, B, 4 * H)), u=(u, (H, 4 * H)),
                         mask=(mask, (B, H)))
    h = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    c = torch.empty_like(h)
    if T == 0:
        return h, c
    _launch.launch("lstm_fwd", entry, (ff, u, mask, h, c), T, B, H)
    launches += 1
    return h, c


def lstm_recurrence_bwd(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dff, du, dmask) from the CUDA kernels on CUDA tensors; the
    plain version on CPU."""
    global bwd_launches
    if ff.device.type == "cpu":
        return lstm_recurrence_bwd_ref(ff, h, c, g, u, mask)
    entry, max_hidden = _launch.bind(BWD_SOURCE, "lstm_bwd", 10, 3)
    T, B, H = _launch.dims("lstm_recurrence_bwd", ff, 4)
    _launch.check_inputs("lstm_recurrence_bwd", H, max_hidden,
                         ff=(ff, (T, B, 4 * H)), h=(h, (T, B, H)),
                         c=(c, (T, B, H)), g=(g, (T, B, H)),
                         u=(u, (H, 4 * H)), mask=(mask, (B, H)))
    dff = torch.empty_like(ff)
    if T == 0:
        return dff, torch.zeros_like(u), torch.zeros_like(mask)
    du = torch.empty_like(u)
    dmask = torch.empty_like(mask)
    ut = u.t().contiguous()  # (4H, H): the dh chain reads it row by row
    _launch.launch("lstm_bwd", entry,
                   (ff, h, c, g, u, ut, mask, dff, du, dmask), T, B, H)
    bwd_launches += 1
    return dff, du, dmask


class LSTMRecurrence(torch.autograd.Function):
    """h = recurrence(ff, u, mask) with the backward kernel as its
    gradient; mask is (B, H).  The c sequence is saved for the backward, as
    tpukaldi's `_fwd` saves it."""

    @staticmethod
    def forward(ctx, ff, u, mask):
        h, c = lstm_recurrence(ff, u, mask)
        ctx.save_for_backward(ff, u, mask, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        ff, u, mask, h, c = ctx.saved_tensors
        return lstm_recurrence_bwd(ff, h, c, g.contiguous(), u, mask)
