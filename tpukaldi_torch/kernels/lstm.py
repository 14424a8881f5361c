"""LSTM recurrence: the hand-written CUDA kernels, forward and backward,
and their plain PyTorch versions, in float32 (K2) and with a bf16
recurrent weight (K4, the "lean" kernels).

    r    = h @ U                  # U = [Uf | Ui | Uo | Uc], (H, 4H)
    f, i, o = sigmoid(ff_{f,i,o} + r_{f,i,o})
    c_t  = i * tanh(ff_c + r_c) * mask + f * c
    h_t  = o * tanh(c_t),         h_0 = c_0 = 0

`LSTMRecurrence` is the counterpart of tpukaldi's
`kernels/lstm.py::lstm_recurrence` (a `jax.custom_vjp`): its forward is
`lstm_recurrence` and saves (ff, u, mask, h, c); its backward is
`lstm_recurrence_bwd`.  On a CUDA tensor the forward launches
`csrc/lstm_fwd.cu` (K2f): one persistent cooperative launch whose CTAs
each keep a column slice of the float32 U in shared memory for all T
steps (where a slice does not fit, its rows that do; the rest streamed
each step, `csrc/u_stream.cuh`), form the gates with float32 FMAs on the CUDA cores
and exchange h through a global ping-pong buffer, one grid barrier a step
(`fwd_plan` reports its grid).  The backward launches `csrc/lstm_bwd.cu` (K2b): the
gates rematerialised for all T * B rows at once by a parallel tiled
float32 pass (so they agree with K2f's to the sum order), then the dh
chain as one persistent cooperative launch on K2f's grid, each CTA keeping
K2f's slice of U in shared memory and exchanging partial dh sums through
a global ping-pong buffer, one grid barrier a step (`bwd_plan` reports its
grid), then the dU pass.  A CUDA tensor launches them or raises; on a CPU
tensor they run `lstm_recurrence_ref` and `lstm_recurrence_bwd_ref`, the
Python time loops that mirror tpukaldi's `lstm_recurrence_scan` and
`_bwd_scan`.

`LSTMLeanRecurrence` is the counterpart of tpukaldi's `lstm_recurrence_lean`
(the QLSTM's recurrence): the same cell with h and U rounded to bf16 as the
operands of every recurrent product, the products exact and summed in
float32, and h and c kept in float32.  Its forward `lstm_recurrence_lean`
launches `csrc/lstm_lean_fwd.cu` (K4f): one persistent cooperative launch
whose CTAs each keep a column slice of U in shared memory for all T steps
(where a slice does not fit, its rows that do; the rest streamed each
step), form
the gates with bf16 tensor-core products and exchange h through a global
ping-pong buffer, one grid barrier a step.  The forwards take H <= 2048,
the backwards H <= 1024: the Functions refuse a gradient past 1024 before
their forward launches.  Its backward
`lstm_recurrence_lean_bwd` launches `csrc/lstm_lean_bwd.cu` (K4b): the
gates rematerialised for all T * B rows at once by a tiled bf16
tensor-core GEMM (so they agree with K4f's to the sum order), then the dh
chain as one persistent cooperative launch whose CTAs own K4f's units, in
groups that share their bf16 dA (one group barrier a step); each keeps a
slice of U in shared memory, forms partial dh sums on the tensor cores
for the rows k of its slice and exchanges them through a global ping-pong
buffer, one grid barrier a step (`lean_bwd_plan` reports its grid and
groups); then dU = h_prev^T dff as one float32 GEMM, as tpukaldi's
`_lean_bwd` contracts it.  On CPU tensors they run `lstm_recurrence_lean_ref` and
`lstm_recurrence_lean_bwd_ref`.  The port's LSTM runs the float32 kernels
at every H, which is what tpukaldi computes off a TPU; the QLSTM picks by
`qlstm_impl` (`models/quaternion.py`).

In the bf16 compute mode the K2 Function widens its bf16 inputs at the
boundary (as the other recurrences' do), while K4 takes a bf16 ff itself,
as tpukaldi's lean kernel reads ff in its native dtype: K4f's and K4b's
bf16 entries widen ff as they load it, and K4b writes dff in bf16; h and c
stay float32 (`lean_bf16_launches` and `lean_bf16_bwd_launches` count
those entries' launches within `lean_launches` and `lean_bwd_launches`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _launch

SOURCE = "lstm_fwd.cu"
BWD_SOURCE = "lstm_bwd.cu"
LEAN_SOURCE = "lstm_lean_fwd.cu"
LEAN_BWD_SOURCE = "lstm_lean_bwd.cu"
# the depth of a stage of K4b's remat, to which its bf16 h_prev and U pad H
# (`csrc/lstm_lean_bwd.cu`, kRmDepth)
LEAN_REMAT_DEPTH = 32

# kernel launches since the last reset (one per wrapper call that launched);
# chip_smoke.py reads them to show that the main path went through the
# kernels
launches = 0
bwd_launches = 0
lean_launches = 0
lean_bwd_launches = 0
# of those, the launches of K4's bf16 entries (a bf16 ff: the bf16 compute
# mode)
lean_bf16_launches = 0
lean_bf16_bwd_launches = 0


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), kept in x's dtype: the operand
    of a bf16 product, whose products with another such operand are exact
    in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


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
    return _lstm_loop(ff, u, mask, act, ln, _identity)


def lstm_recurrence_lean_ref(
    ff: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4f's computation: `lstm_recurrence_ref` with h and u rounded to bf16
    as the operands of each step's product, which is exact and summed in
    float32 (tpukaldi's `_lstm_lean_kernel`); h and c stay float32.  A bf16
    ff is read widened, as the kernel reads it (tpukaldi's `ff_ref[k]
    .astype(float32)`)."""
    return _lstm_loop(_launch.widen(ff), _bf16(u), mask, torch.tanh, None,
                      _bf16)


def _lstm_loop(ff, u, mask, act, ln, operand):
    # bf16 inputs (the bf16 compute mode's scan) carry bf16 h and c
    dtype = ff.dtype
    keep = _launch.carry(dtype)
    ff, u, mask = (_launch.widen(t) for t in (ff, u, mask))
    H = ff.shape[-1] // 4
    h = ff.new_zeros((ff.shape[1], H))
    c = ff.new_zeros((ff.shape[1], H))
    hs, cs = [], []
    for ff_t in ff:
        a = ff_t + operand(h) @ u
        f = torch.sigmoid(a[:, :H])
        i = torch.sigmoid(a[:, H:2 * H])
        o = torch.sigmoid(a[:, 2 * H:3 * H])
        c = keep(i * act(a[:, 3 * H:]) * mask + f * c)
        h = keep(o * act(c))
        if ln is not None:
            h = keep(ln(h))
        hs.append(h)
        cs.append(c)
    return torch.stack(hs).to(dtype), torch.stack(cs).to(dtype)


def lstm_recurrence_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's computation as a reverse-time loop (tpukaldi's
    `_bwd_scan`): ff, h and c (the forward's outputs), g = dL/dh, u, mask
    (B, H) -> (dff (T, B, 4H), du (H, 4H), dmask (B, H))."""
    return _lstm_bwd_loop(ff, h, c, g, u, mask, _identity)


def lstm_recurrence_lean_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b's computation and the dU contraction after it (tpukaldi's
    `_lstm_lean_bwd_kernel` and `_lean_bwd`): the gates recomputed with the
    forward's bf16 products, the dh chain as bf16(dA) @ bf16(u)^T summed in
    float32, and du = h_prev^T dff in float32.  A bf16 ff is read widened
    and gives dff in bf16, dA rounded to nearest even, and du from that
    rounded dff (tpukaldi writes dff in ff's dtype and contracts dU over
    it)."""
    if ff.dtype != torch.bfloat16:
        return _lstm_bwd_loop(ff, h, c, g, u, mask, _bf16)
    dff, _, dmask = _lstm_bwd_loop(ff.float(), h, c, g, u, mask, _bf16)
    dff = dff.to(torch.bfloat16)
    H = h.shape[2]
    du = h[:-1].reshape(-1, H).t() @ dff[1:].reshape(-1, 4 * H).float()
    return dff, du, dmask


def _lstm_bwd_loop(ff, h, c, g, u, mask, operand):
    T, B, H4 = ff.shape
    H = H4 // 4
    zeros = h.new_zeros((1, B, H))
    h_prev = torch.cat([zeros, h[:-1]])
    c_prev = torch.cat([zeros, c[:-1]])
    u_op = operand(u)
    a = ff + (operand(h_prev).reshape(T * B, H) @ u_op).reshape(T, B, H4)
    f = torch.sigmoid(a[..., :H])
    i = torch.sigmoid(a[..., H:2 * H])
    o = torch.sigmoid(a[..., 2 * H:3 * H])
    cand = torch.tanh(a[..., 3 * H:])
    tanh_c = torch.tanh(c)
    ut = u_op.t()
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
        dh = operand(dff[t]) @ ut
        dc = dc * f[t]
    du = h_prev.reshape(T * B, H).t() @ dff.reshape(T * B, H4)
    return dff, du, dmask


def lstm_recurrence(ff: torch.Tensor, u: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (h, c): launch K2f on a CUDA tensor (u is packed once per
    call); the plain version on CPU.  Builds no autograd graph of its own:
    `LSTMRecurrence` is the differentiable entry."""
    global launches
    _launch.refuse_bf16("lstm_recurrence", ff, u, mask)
    if ff.device.type == "cpu":
        return lstm_recurrence_ref(ff, u, mask)
    entry, max_hidden = _launch.bind(SOURCE, "lstm_fwd", 7, 3)
    T, B, H = _launch.dims("lstm_recurrence", ff, 4)
    _launch.check_inputs("lstm_recurrence", H, max_hidden,
                         ff=(ff, (T, B, 4 * H)), u=(u, (H, 4 * H)),
                         mask=(mask, (B, H)))
    h = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    c = torch.empty_like(h)
    if T == 0:
        return h, c
    # the kernel's scratch: the ping-pong buffer of h, B and H padded to 4
    # (the padding stays zero), and the grid barrier's counter
    hbuf = torch.zeros((2, _pad(B, 4), _pad(H, 4)), device=ff.device,
                       dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("lstm_fwd", entry,
                   (ff, _pack(u, H, torch.float32), mask, h, c, hbuf, bar),
                   T, B, H)
    launches += 1
    return h, c


def fwd_plan(B: int, H: int) -> dict:
    """K2f's launch at (B, H) on the current card: its CTAs, the hidden
    units each owns, each CTA's shared-memory bytes, the h columns it
    stages at a time, the rows of its slice of U each CTA keeps resident
    (`k_res`; H padded to 4 where the whole slice fits) and the bytes of U
    the grid streams a step past them (`stream_bytes`).  Raises where the
    card cannot hold the grid at once, as the launch would."""
    return _launch.plan(SOURCE, "lstm_fwd", B, H, "k_res", "stream_bytes")


def lstm_recurrence_bwd(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dff, du, dmask) from K2b on CUDA tensors (u is packed
    once per call, as for K2f); the plain version on CPU."""
    global bwd_launches
    _launch.refuse_bf16("lstm_recurrence_bwd", ff, h, c, g, u, mask)
    if ff.device.type == "cpu":
        return lstm_recurrence_bwd_ref(ff, h, c, g, u, mask)
    entry, max_hidden = _launch.bind(BWD_SOURCE, "lstm_bwd", 12, 3)
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
    # the kernel's scratch: the ping-pong buffer of partial dh sums (every
    # word read is written first) and the grid barrier's counter
    pbuf = torch.empty(bwd_plan(B, H)["pbuf_floats"], device=ff.device,
                       dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("lstm_bwd", entry,
                   (ff, h, c, g, u, _pack(u, H, torch.float32), mask, dff, du,
                    dmask, pbuf, bar), T, B, H)
    bwd_launches += 1
    return dff, du, dmask


def bwd_plan(B: int, H: int) -> dict:
    """K2b's sequential launch at (B, H) on the current card: its CTAs, the
    hidden units each owns, each CTA's shared-memory bytes, the producers'
    partial sums it stages at a time (`chunk`) and the floats of the
    partial-sum buffer.  Raises where the card cannot hold the grid at
    once, as the launch would."""
    return _launch.plan(BWD_SOURCE, "lstm_bwd", B, H, "pbuf_floats")


class LSTMRecurrence(torch.autograd.Function):
    """h = recurrence(ff, u, mask) with the backward kernel as its
    gradient; mask is (B, H).  The c sequence is saved for the backward, as
    tpukaldi's `_fwd` saves it.  bf16 inputs are widened to float32 at the
    boundary (`kernels/ligru.py::LiGRURecurrence` says how); h is float32,
    the gradients come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, ff, u, mask):
        if ff.device.type == "cuda":
            _launch.refuse_wide_backward("lstm_recurrence_bwd", ctx,
                                         u.shape[0], BWD_SOURCE, "lstm_bwd")
        w = _launch.widen
        h, c = lstm_recurrence(w(ff), w(u), w(mask))
        ctx.save_for_backward(ff, u, mask, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        ff, u, mask, h, c = ctx.saved_tensors
        w = _launch.widen
        grads = lstm_recurrence_bwd(w(ff), h, c, g.contiguous(), w(u),
                                    w(mask))
        return tuple(d.to(p.dtype) for d, p in zip(grads, (ff, u, mask)))


def _pack(u: torch.Tensor, H: int,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(H, H, 4) of `dtype` with [k, j, g] = U[k, gH + j]: unit j's four gate
    weights of row k side by side, so a K4f, K4b, K2f or K2b CTA's slice
    of row k is one contiguous run."""
    return u.view(H, 4, H).permute(0, 2, 1).to(dtype).contiguous()


def lstm_recurrence_lean(ff: torch.Tensor, u: torch.Tensor,
                         mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (h, c) with bf16 recurrent products: launch K4f on a CUDA
    tensor (u, float32, is rounded and packed once per call); the plain
    version on CPU.  ff is float32 or bf16 (the bf16 compute mode): a bf16
    ff goes to K4f's bf16 entry, which widens it as it loads it, so h and c
    are the float32 entry's on ff.float().  Builds no autograd graph of its
    own: `LSTMLeanRecurrence` is the differentiable entry."""
    global lean_launches, lean_bf16_launches
    _launch.refuse_bf16("lstm_recurrence_lean", u, mask)
    if ff.device.type == "cpu":
        return lstm_recurrence_lean_ref(ff, u, mask)
    half = ff.dtype == torch.bfloat16
    entry, max_hidden = _launch.bind(
        LEAN_SOURCE, "lstm_lean_fwd_bf16" if half else "lstm_lean_fwd", 7, 3)
    T, B, H = _launch.dims("lstm_recurrence_lean", ff, 4)
    _launch.check_inputs("lstm_recurrence_lean", H, max_hidden,
                         {"ff": ff.dtype if half else torch.float32},
                         ff=(ff, (T, B, 4 * H)), u=(u, (H, 4 * H)),
                         mask=(mask, (B, H)))
    h = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    c = torch.empty_like(h)
    if T == 0:
        return h, c
    # the kernel's scratch: the ping-pong buffer of h's bf16 operands, B and
    # H padded to 16 (the padding stays zero), and the grid barrier's counter
    hbuf = torch.zeros((2, _pad(B, 16), _pad(H, 16)), device=ff.device,
                       dtype=torch.bfloat16)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("lstm_lean_fwd", entry,
                   (ff, _pack(u, H), mask, h, c, hbuf, bar), T, B, H)
    lean_launches += 1
    lean_bf16_launches += half
    return h, c


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def lean_fwd_plan(B: int, H: int) -> dict:
    """K4f's launch at (B, H) on the current card, as `fwd_plan` gives
    K2f's (`k_res` is H padded to 16 where the whole slice fits)."""
    return _launch.plan(LEAN_SOURCE, "lstm_lean_fwd", B, H, "k_res",
                        "stream_bytes")


def lstm_recurrence_lean_bwd(
    ff: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
    u: torch.Tensor, mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward (dff, du, dmask) with bf16 recurrent products: K4b on CUDA
    tensors for dff and dmask (its bf16 operands made once per call), then
    du = h_prev^T dff as one float32 GEMM over the T * B rows (h_prev[0] =
    0 adds nothing); the plain version on CPU.  A bf16 ff goes to K4b's
    bf16 entry: its remat widens ff as it loads it into a float32 buffer
    of the gates, and its chain writes dff in bf16, dA rounded to nearest
    even, from which du is contracted (widened), as tpukaldi's `_lean_bwd`
    contracts it over its native-dtype dff."""
    global lean_bwd_launches, lean_bf16_bwd_launches
    _launch.refuse_bf16("lstm_recurrence_lean_bwd", h, c, g, u, mask)
    if ff.device.type == "cpu":
        return lstm_recurrence_lean_bwd_ref(ff, h, c, g, u, mask)
    half = ff.dtype == torch.bfloat16
    entry, max_hidden = _launch.bind(
        LEAN_BWD_SOURCE, "lstm_lean_bwd_bf16" if half else "lstm_lean_bwd",
        13 if half else 12, 3)
    T, B, H = _launch.dims("lstm_recurrence_lean_bwd", ff, 4)
    _launch.check_inputs("lstm_recurrence_lean_bwd", H, max_hidden,
                         {"ff": ff.dtype if half else torch.float32},
                         ff=(ff, (T, B, 4 * H)), h=(h, (T, B, H)),
                         c=(c, (T, B, H)), g=(g, (T, B, H)),
                         u=(u, (H, 4 * H)), mask=(mask, (B, H)))
    dff = torch.empty_like(ff)
    if T == 0:
        return dff, torch.zeros_like(u), torch.zeros_like(mask)
    dmask = torch.empty_like(mask)
    # the bf16 entry's float32 gates and dA (the float32 entry keeps them in
    # dff itself)
    gates = ((torch.empty(ff.shape, device=ff.device, dtype=torch.float32),)
             if half else ())
    # the chain's scratch: the ping-pong buffer of partial dh sums (every
    # word read is written first), the groups' bf16 dA (its padding columns
    # read as zeros) and the barriers' counters, the grid's and each group's
    plan = lean_bwd_plan(B, H)
    pbuf = torch.empty(plan["pbuf_floats"], device=ff.device,
                       dtype=torch.float32)
    dabuf = torch.zeros(plan["dabuf_halves"], device=ff.device,
                        dtype=torch.bfloat16)
    bar = torch.zeros(1 + plan["groups"], device=ff.device, dtype=torch.int32)
    _launch.launch("lstm_lean_bwd", entry,
                   (ff, c, g, *lean_bwd_operands(h, u), mask, *gates, dff,
                    dmask, pbuf, dabuf, bar), T, B, H)
    lean_bwd_launches += 1
    lean_bf16_bwd_launches += half
    du = h[:-1].reshape(-1, H).t() @ dff[1:].reshape(-1, 4 * H).float()
    return dff, du, dmask


def lean_bwd_operands(h: torch.Tensor, u: torch.Tensor):
    """K4b's bf16 operands, made once per call: the remat's h_prev (T B,
    hk), its first B rows zero, and U (hk, 4H padded to 8), both with H
    padded to the remat's stage depth hk with zeros; and the chain's packed
    U (`_pack`)."""
    T, B, H = h.shape
    hk = _pad(H, LEAN_REMAT_DEPTH)
    hp = h.new_zeros((T * B, hk), dtype=torch.bfloat16)
    hp[B:, :H] = h[:-1].reshape(-1, H)
    u16 = u.new_zeros((hk, _pad(4 * H, 8)), dtype=torch.bfloat16)
    u16[:H, :4 * H] = u
    return hp, u16, _pack(u, H)


def lean_bwd_plan(B: int, H: int) -> dict:
    """K4b's sequential launch at (B, H) on the current card, as `bwd_plan`
    gives K2b's, and its groups: `groups` of `group_ctas` CTAs each."""
    return _launch.plan(LEAN_BWD_SOURCE, "lstm_lean_bwd", B, H, "pbuf_floats",
                 "groups", "group_ctas", "dabuf_halves")


class LSTMLeanRecurrence(torch.autograd.Function):
    """h = lean recurrence(ff, u, mask) with K4b as its gradient; mask is
    (B, H).  Saves (ff, u, mask, h, c), as tpukaldi's `_lean_fwd` does.
    ff goes to the kernels in its own dtype (bf16 in the bf16 compute mode,
    as tpukaldi's lean kernel reads its native-dtype ff), u and mask
    widened at the boundary; dff comes back in ff's dtype, du and dmask in
    u's and mask's."""

    @staticmethod
    def forward(ctx, ff, u, mask):
        if ff.device.type == "cuda":
            _launch.refuse_wide_backward("lstm_recurrence_lean_bwd", ctx,
                                         u.shape[0], LEAN_BWD_SOURCE,
                                         "lstm_lean_bwd")
        w = _launch.widen
        h, c = lstm_recurrence_lean(ff, w(u), w(mask))
        ctx.save_for_backward(ff, u, mask, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        ff, u, mask, h, c = ctx.saved_tensors
        w = _launch.widen
        dff, du, dmask = lstm_recurrence_lean_bwd(ff, h, c, g.contiguous(),
                                                  w(u), w(mask))
        return dff, du.to(u.dtype), dmask.to(mask.dtype)
