"""Li-GRU recurrence: the hand-written CUDA kernels, forward and backward,
and their plain PyTorch versions.

    r    = h @ U                  # U = [Uh | Uz], (H, 2H)
    z_t  = sigmoid(ffz_t + r_z)
    hc   = relu(ffh_t + r_h) * mask
    h_t  = z_t * h + (1 - z_t) * hc,   h_0 = 0

`LiGRURecurrence` is the counterpart of tpukaldi's
`kernels/ligru.py::ligru_recurrence` (a `jax.custom_vjp`): its forward is
`ligru_recurrence` and saves (ff, u, mask, h); its backward is
`ligru_recurrence_bwd`.  On a CUDA tensor those launch `csrc/ligru_fwd.cu`
and `csrc/ligru_bwd.cu` (design notes there) or raise; on a CPU tensor they
run `ligru_recurrence_ref` and `ligru_recurrence_bwd_ref`, the Python time
loops that mirror tpukaldi's `ligru_recurrence_scan` and `_bwd_scan`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _launch

SOURCE = "ligru_fwd.cu"
BWD_SOURCE = "ligru_bwd.cu"

# kernel launches since the last reset (one per wrapper call that launched:
# the backward's call runs its sequential and dU kernels); chip_smoke.py
# reads them to show that the main path went through the kernels
launches = 0
bwd_launches = 0


def ligru_recurrence_ref(
    ff: torch.Tensor,
    u: torch.Tensor,
    mask: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """ff (T, B, 2H), u (H, 2H), mask (B, H) or broadcastable -> h (T, B, H).

    With the defaults it is the kernel's computation.  `act` and `ln` (a
    layer norm applied to each h_t, reference neural_networks.py:1130-1141)
    cover the liGRU layers the kernel does not take."""
    H = ff.shape[-1] // 2
    h = ff.new_zeros((ff.shape[1], H))
    out = []
    for ff_t in ff:
        r = h @ u
        zt = torch.sigmoid(ff_t[:, H:] + r[:, H:])
        hc = act(ff_t[:, :H] + r[:, :H]) * mask
        h = zt * h + (1 - zt) * hc
        if ln is not None:
            h = ln(h)
        out.append(h)
    return torch.stack(out)


def ligru_recurrence_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's computation as a reverse-time loop (tpukaldi's
    `_bwd_scan`): ff, h (the forward's output), g = dL/dh, u, mask (B, H) ->
    (dff (T, B, 2H), du (H, 2H), dmask (B, H))."""
    T, B, H2 = ff.shape
    H = H2 // 2
    h_prev = torch.cat([h.new_zeros((1, B, H)), h[:-1]])
    r = (h_prev.reshape(T * B, H) @ u).reshape(T, B, H2)
    a_h = ff[..., :H] + r[..., :H]
    zt = torch.sigmoid(ff[..., H:] + r[..., H:])
    relu_ah = torch.clamp_min(a_h, 0.0)
    hc = relu_ah * mask
    apos = (a_h > 0.0).to(ff.dtype)
    ut = u.t()
    dff = ff.new_empty((T, B, H2))
    dhc_seq = ff.new_empty((T, B, H))
    dh = ff.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        gh = g[t] + dh
        dz = gh * (h_prev[t] - hc[t])
        dff[t, :, H:] = dz * zt[t] * (1.0 - zt[t])
        dhc = gh * (1.0 - zt[t])
        dff[t, :, :H] = dhc * mask * apos[t]
        dhc_seq[t] = dhc
        dh = gh * zt[t] + dff[t] @ ut
    du = h_prev.reshape(T * B, H).t() @ dff.reshape(T * B, H2)
    dmask = (dhc_seq * relu_ah).sum(dim=0)
    return dff, du, dmask


def ligru_recurrence(ff: torch.Tensor, u: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Forward: launch the CUDA kernel on a CUDA tensor; the plain version on
    CPU.  Builds no autograd graph of its own: `LiGRURecurrence` is the
    differentiable entry."""
    global launches
    if ff.device.type == "cpu":
        return ligru_recurrence_ref(ff, u, mask)
    entry, max_hidden = _launch.bind(SOURCE, "ligru_fwd", 4, 3)
    T, B, H = _launch.dims("ligru_recurrence", ff, 2)
    _launch.check_inputs("ligru_recurrence", H, max_hidden,
                         ff=(ff, (T, B, 2 * H)), u=(u, (H, 2 * H)),
                         mask=(mask, (B, H)))
    out = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    if T == 0:
        return out
    _launch.launch("ligru_fwd", entry, (ff, u, mask, out), T, B, H)
    launches += 1
    return out


def ligru_recurrence_bwd(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dff, du, dmask) from the CUDA kernels on CUDA tensors; the
    plain version on CPU."""
    global bwd_launches
    if ff.device.type == "cpu":
        return ligru_recurrence_bwd_ref(ff, h, g, u, mask)
    entry, max_hidden = _launch.bind(BWD_SOURCE, "ligru_bwd", 9, 3)
    T, B, H = _launch.dims("ligru_recurrence_bwd", ff, 2)
    _launch.check_inputs("ligru_recurrence_bwd", H, max_hidden,
                         ff=(ff, (T, B, 2 * H)), h=(h, (T, B, H)),
                         g=(g, (T, B, H)), u=(u, (H, 2 * H)),
                         mask=(mask, (B, H)))
    dff = torch.empty_like(ff)
    if T == 0:
        return dff, torch.zeros_like(u), torch.zeros_like(mask)
    du = torch.empty_like(u)
    dmask = torch.empty_like(mask)
    ut = u.t().contiguous()  # (2H, H): the dh chain reads it row by row
    _launch.launch("ligru_bwd", entry,
                   (ff, h, g, u, ut, mask, dff, du, dmask), T, B, H)
    bwd_launches += 1
    return dff, du, dmask


class LiGRURecurrence(torch.autograd.Function):
    """h = recurrence(ff, u, mask) with the backward kernel as its
    gradient; mask is (B, H)."""

    @staticmethod
    def forward(ctx, ff, u, mask):
        h = ligru_recurrence(ff, u, mask)
        ctx.save_for_backward(ff, u, mask, h)
        return h

    @staticmethod
    def backward(ctx, g):
        ff, u, mask, h = ctx.saved_tensors
        return ligru_recurrence_bwd(ff, h, g.contiguous(), u, mask)
