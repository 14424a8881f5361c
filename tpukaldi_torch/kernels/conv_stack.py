"""The whole raw-waveform conv stack of the CNN front-end in one call: the
hand-written CUDA kernels K7f and K7b, and their plain PyTorch versions, in
float32.

    layer 0    K6 (kernels/conv1d.py): a valid conv of K0 <= 129 taps over
               one channel, max-pool, bias, layer norm over time, relu,
               hash-mask dropout; 128 filters
    layer i    i >= 1, over the previous layer's output h (N, lin, C), C <= 128:
               c[n, t, o] = sum_{c, k} h[n, t + k, c] * W[o, c, k]   t < ct = M*P
               y = max over each pool of P conv rows (the tail dropped) + b,
                   idx = the first row that reaches it (int8)
               z = ((y - mu) * r) * g + be   mean and unbiased std over the
                   M pooled rows per (window, filter), r = 1 / (std + eps)
               relu (one flag for every layer), inverted dropout

The dropout mask of layer i is tpukaldi's counter hash (`conv1d.drop_mask`)
of the window id n + i * 2^20 (n: the window's row in the call) and the
element id m * 128 + o in every layer, whatever its filter count, as
tpukaldi builds each layer's mask over 128 lanes; layer 0's is K6's mask.

`ConvStack` is the counterpart of tpukaldi's
`kernels/conv_stack.py::conv_stack_fused` (a `jax.custom_vjp`, with the same
layouts: x (N, L), w0 (K0, O0), gt0 and bt0 (M0, O0), per upper layer
(kernel (O, I, K), bias (O,), gamma (M, O), beta (M, O)), gamma and beta
time-major; the result (N, M_last, O_last)).  On a CUDA tensor its forward
launches K6f for layer 0 and then `csrc/conv_stack_fwd.cu` (K7f) once per
upper layer; its backward launches `csrc/conv_stack_bwd.cu` (K7b) per upper
layer from the top down, then K6b for layer 0 on K6f's saved pooled value
(dx only where x needs a gradient); or they raise.  On a CPU
tensor they run the plain versions (`conv_stack_ref`,
`conv_stack_bwd_ref`), which follow tpukaldi's `_stack_fwd_kernel` and
`_stack_bwd_kernel`.  Every conv bias's gradient is an exact zero: the
layer norm's mean cancels it.  The forward keeps each upper layer's input
and its pooled value y = max-pool(conv) + bias for the backward (tpukaldi
recomputes the stack instead; the plain backward recomputes y where it is
not given).  No module of the port calls the stack, as no module of
tpukaldi does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, _launch, conv1d
from .conv1d import Seed

SOURCE = "conv_stack_fwd.cu"
BWD_SOURCE = "conv_stack_bwd.cu"

SALT = 1 << 20  # layer i's window ids are offset by i * SALT (tpukaldi's _SALT)
MASK_LANES = 128  # the element id's row stride in every layer's mask
LAYER0_FILTERS = 128
# the kernels' limits (csrc/stack_tile.cuh's kMaxUpperK, kMaxChannels,
# kMaxStackPool), restated for the gate, which runs on the CPU as well
MAX_UPPER_K = 8  # taps an upper layer's kernels unroll
MAX_CHANNELS = 128  # filters, and so input channels, of an upper layer
# the stack's own limits on layer 0's taps and on every layer's pool: the
# envelope it was designed and held at, narrower than K6's own
# (conv1d.MAX_K, MAX_POOL), which the stack does not widen with it
MAX_LAYER0_K = 129
MAX_POOL = 12

# kernel launches since the last reset (one per wrapper call that launched:
# the forward's call runs K6f and one upper-layer kernel per layer, the
# backward's the upper layers' passes and K6b); chip_smoke.py reads them to
# show that the stack's path went through the kernels
launches = 0
bwd_launches = 0

# per upper layer: (kernel (O, I, K), bias (O,), gamma (M, O), beta (M, O)),
# and what the forward keeps of it: (its input h (N, lin, I), idx (N, M, O)
# int8, stats (N, 2, O) = (mean, std), y (N, M, O) the pooled value plus
# bias); none of them when serving
Upper = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
UpperRes = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                 Optional[torch.Tensor], Optional[torch.Tensor]]
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def stack_geometry(inp_dim: int, len_filt: Sequence[int],
                   pools: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """(lin, K, pool, ct, M) per layer: its input length, taps, pool, the
    conv rows the pool reads (ct = M * pool, the only ones computed) and
    its pooled length; tpukaldi's `stack_geometry`."""
    geo, cur = [], inp_dim
    for K, P in zip(len_filt, pools):
        M = (cur - K + 1) // P
        geo.append((cur, K, P, M * P, M))
        cur = M
    return tuple(geo)


def stack_supported(len_filt: Sequence[int], n_filt: Sequence[int],
                    inp_dim: int, pools: Sequence[int]) -> bool:
    """True for a stack the port's kernels take; otherwise a ValueError
    with the reason (there is nothing to fall back to).  Layer 0 is K6's
    (K0 <= 129, pool <= 12) with 128 filters: the stack's masks id the
    elements m * 128 + o, which K6's m * O + o equal only at O = 128.  An
    upper layer takes K <= 8 taps (the kernels unroll them), pool <= 12 and
    at most 128 filters.  Every layer leaves a pooled row.  The kernels' C
    entries refuse a layer that needs more shared memory than a block may
    use (a ValueError at launch).  tpukaldi's 128-lane and VMEM conditions
    are its TPU's, and are not copied."""
    n = len(n_filt)
    if n < 2 or len(len_filt) != n or len(pools) != n:
        raise ValueError(
            f"conv_stack_fused needs layer 0 and at least one upper layer, "
            f"each with taps, filters and a pool; got len_filt={len_filt}, "
            f"n_filt={n_filt}, pools={pools}")
    if n_filt[0] != LAYER0_FILTERS:
        raise ValueError(
            f"conv_stack_fused: layer 0 takes {LAYER0_FILTERS} filters (its "
            f"dropout ids elements m * 128 + o, as K6 does only at O = 128), "
            f"got {n_filt[0]}")
    if not 1 <= len_filt[0] <= MAX_LAYER0_K:
        raise ValueError(f"conv_stack_fused: layer 0 takes 1 <= K <= "
                         f"{MAX_LAYER0_K}, got {len_filt[0]}")
    for i, (lin, K, P, ct, M) in enumerate(
            stack_geometry(inp_dim, len_filt, pools)):
        if not 1 <= P <= MAX_POOL:
            raise ValueError(f"conv_stack_fused: layer {i} takes 1 <= pool "
                             f"<= {MAX_POOL}, got {P}")
        if i and not 1 <= K <= MAX_UPPER_K:
            raise ValueError(f"conv_stack_fused: upper layer {i} takes 1 <= "
                             f"K <= {MAX_UPPER_K}, got {K}")
        if i and not 1 <= n_filt[i] <= MAX_CHANNELS:
            raise ValueError(f"conv_stack_fused: upper layer {i} takes 1 to "
                             f"{MAX_CHANNELS} filters, got {n_filt[i]}")
        if M < 1:
            raise ValueError(f"conv_stack_fused: layer {i} ({lin} rows, K={K}"
                             f", pool={P}) leaves no pooled row")
    return True


def _geometry(x, w0, bias0, gt0, bt0, ups: Sequence[Upper],
              pools: Sequence[int], drops: Sequence[float]):
    """The stack's geometry, after the gate and a check of every shape."""
    if x.dim() != 2 or w0.dim() != 2:
        raise ValueError(f"conv_stack_fused: x must be (N, L) and w0 (K0, O0), "
                         f"got {tuple(x.shape)} and {tuple(w0.shape)}")
    if len(drops) != len(ups) + 1:
        raise ValueError(f"conv_stack_fused: one drop rate per layer, got "
                         f"{len(drops)} for {len(ups) + 1} layers")
    if any(u[0].dim() != 3 for u in ups):
        raise ValueError("conv_stack_fused: each upper kernel must be (O, I, K)")
    n_filt = [w0.shape[1]] + [u[0].shape[0] for u in ups]
    len_filt = [w0.shape[0]] + [u[0].shape[2] for u in ups]
    stack_supported(len_filt, n_filt, x.shape[1], pools)
    geo = stack_geometry(x.shape[1], len_filt, pools)
    want = {"bias0": (n_filt[0],), "gt0": (geo[0][4], n_filt[0]),
            "bt0": (geo[0][4], n_filt[0])}
    got = {"bias0": bias0.shape, "gt0": gt0.shape, "bt0": bt0.shape}
    for i, (kernel, b, g, be) in enumerate(ups, 1):
        O, M = n_filt[i], geo[i][4]
        want.update({f"kernel{i}": (O, n_filt[i - 1], len_filt[i]),
                     f"bias{i}": (O,), f"gamma{i}": (M, O), f"beta{i}": (M, O)})
        got.update({f"kernel{i}": kernel.shape, f"bias{i}": b.shape,
                    f"gamma{i}": g.shape, f"beta{i}": be.shape})
    got = {k: tuple(v) for k, v in got.items()}
    if got != want:
        raise ValueError(f"conv_stack_fused: expected shapes {want}, got {got}")
    return geo


# ----------------------------------------------------------------- plain
def _upper_conv(h: torch.Tensor, w: torch.Tensor, ct: int) -> torch.Tensor:
    """h (N, lin, I), w (O, I, K) -> the valid conv over the first ct rows,
    (N, ct, O)."""
    K = w.shape[2]
    return F.conv1d(h[:, :ct + K - 1].transpose(1, 2), w).transpose(1, 2)


def recompute_y(h, w, b, idx, pool: int) -> torch.Tensor:
    """An upper layer's pooled value plus bias (N, M, O) from its input h
    and the forward's argmax idx: the plain backward's recompute of the y
    that the forward keeps (the same conv, so the same bits)."""
    conv = _upper_conv(h, w, idx.shape[1] * pool)
    return conv1d._pooled_at(conv, idx, pool) + b


def stack_mask(seed: Seed, N: int, layer: int, M: int, O: int, drop: float,
               device=None) -> torch.Tensor:
    """Layer `layer`'s keep mask (N, M, O): tpukaldi's hash of window id
    n + layer * 2^20 over (M, 128) lanes, the first O."""
    wid = torch.arange(N, dtype=torch.int64, device=device) + layer * SALT
    return conv1d.drop_mask(seed, wid, M, MASK_LANES, drop)[..., :O]


def _ln_act_drop(y, g, be, seed: Seed, layer: int, eps: float, relu: bool,
                 drop: float):
    """An upper layer from its pooled y + bias: (z, stats (N, 2, O))."""
    N, M, O = y.shape
    mu = y.sum(1, keepdim=True) / M
    c = y - mu
    s = torch.sqrt((c * c).sum(1, keepdim=True) / max(M - 1, 1))
    z = (c * (1.0 / (s + eps))) * g + be
    if relu:
        z = torch.relu(z)
    if drop > 0.0:
        keep = stack_mask(seed, N, layer, M, O, drop, z.device)
        z = torch.where(keep, z * conv1d.drop_scale(drop).to(z.device), 0.0)
    return z, torch.cat([mu, s], dim=1)


def conv_stack_ref(x, w0, bias0, gt0, bt0, ups: Sequence[Upper], seed: Seed,
                   pools: Sequence[int], eps: float, relu: bool,
                   drops: Sequence[float]):
    """-> (out (N, M_last, O_last), idx0, stats0, per upper layer
    (input h, idx, stats, y)): K6's plain version, then each upper layer."""
    z, idx0, stats0 = conv1d.conv1d_pool_ln_act_ref(
        x, w0, bias0, gt0, bt0, seed, pools[0], eps, relu, drops[0])
    out, res = upper_ref(z, ups, seed, pools, eps, relu, drops)
    return out, idx0, stats0, res


def upper_ref(z, ups: Sequence[Upper], seed: Seed, pools: Sequence[int],
              eps: float, relu: bool, drops: Sequence[float]):
    """The upper layers' plain forward from layer 0's output z -> (out,
    per upper layer (input h, idx, stats, y))."""
    res = []
    for i, (w, b, g, be) in enumerate(ups, 1):
        P = pools[i]
        m, idx = conv1d._pool_argmax(_upper_conv(z, w, g.shape[0] * P), P)
        y = m + b
        out, stats = _ln_act_drop(y, g, be, seed, i, eps, relu, drops[i])
        res.append((z, idx, stats, y))
        z = out
    return z, tuple(res)


def conv_stack_bwd_ref(x, w0, bias0, gt0, bt0, ups: Sequence[Upper],
                       seed: Seed, idx0, stats0, ups_res: Sequence[UpperRes],
                       dz, pools: Sequence[int], eps: float, relu: bool,
                       drops: Sequence[float]):
    """The stack's backward as tpukaldi's `_stack_bwd_kernel` computes it,
    from the top layer down: each upper layer's pooled value y as the
    forward kept it, or, where it is None, recomputed at the saved argmax
    from the saved input (the same bits), the mask and the relu gate
    rebuilt from z = xhat * g + be, the layer norm's backward with s
    floored at 1e-30, the scatter through the pool, then dW and dX; layer 0
    through K6's plain backward.  -> (dx, dw0, dbias0, dgt0, dbt0, per
    upper layer (dW, dbias (exact 0), dgamma, dbeta))."""
    d, dups = upper_bwd_ref(ups, seed, ups_res, dz, pools, eps, relu, drops)
    grads0 = conv1d.conv1d_pool_ln_act_bwd_ref(
        x, w0, bias0, gt0, bt0, seed, idx0, stats0, d.contiguous(), pools[0],
        eps, relu, drops[0])
    return (*grads0, dups)


def upper_bwd_ref(ups: Sequence[Upper], seed: Seed,
                  ups_res: Sequence[UpperRes], dz, pools: Sequence[int],
                  eps: float, relu: bool, drops: Sequence[float]):
    """The upper layers' plain backward, from the top layer down, as
    `conv_stack_bwd_ref` runs it -> (the gradient of layer 0's output, per
    upper layer (dW, dbias (exact 0), dgamma, dbeta))."""
    d = dz
    dups = []
    for i in range(len(ups), 0, -1):
        w, b, g, be = ups[i - 1]
        h, idx, stats, y = ups_res[i - 1]
        P, K = pools[i], w.shape[2]
        N, M, O = idx.shape
        ct = M * P
        if y is None:
            y = recompute_y(h, w, b, idx, P)
        # one layout, given or recomputed: the sums below follow it
        y = y.contiguous()
        mu, s = stats[:, 0:1], stats[:, 1:2]
        r = 1.0 / (s + eps)
        c = y - mu
        xhat = c * r
        if drops[i] > 0.0:
            keep = stack_mask(seed, N, i, M, O, drops[i], d.device)
            d = torch.where(keep, d * conv1d.drop_scale(drops[i]).to(d.device),
                            0.0)
        if relu:
            d = torch.where(xhat * g + be > 0.0, d, 0.0)
        dg = (d * xhat).sum(0)
        dbe = d.sum(0)
        dzg = d * g
        A = dzg.sum(1, keepdim=True)
        B = (dzg * c).sum(1, keepdim=True)
        fac = (B * r * r) / (max(M - 1, 1) * s.clamp_min(1e-30))
        dy = r * dzg - c * fac - (r / M) * A
        dconv = dy.new_zeros((N, ct, O))
        dconv.view(N, M, P, O).scatter_(2, idx.long()[:, :, None, :],
                                        dy[:, :, None, :])
        dh, dw, _ = torch.ops.aten.convolution_backward(
            dconv.transpose(1, 2).contiguous(),
            h[:, :ct + K - 1].transpose(1, 2).contiguous(), w, None, [1], [0],
            [1], False, [0], 1, [True, True, False])
        d = F.pad(dh.transpose(1, 2), (0, 0, 0, h.shape[1] - (ct + K - 1)))
        dups.append((dw, torch.zeros_like(b), dg, dbe))
    return d, tuple(reversed(dups))


# ----------------------------------------------------------------- kernels
def _seed_of(seed: Seed, drops: Sequence[float], device):
    """The seed as the plain versions take it on the CPU, or as an int32 on
    the card for the kernels (a null pointer without dropout)."""
    if device.type == "cpu":
        return int(seed) if any(d > 0.0 for d in drops) else 0
    return (conv1d._seed_tensor(seed, device)
            if any(d > 0.0 for d in drops) else None)


def _scratch(source: str, name: str, *dims) -> int:
    """The floats of scratch the C entry `tpk_<name>` asks for at these
    dimensions (its `tpk_<name>_scratch`)."""
    fn = getattr(_build.load(source), f"tpk_{name}_scratch")
    if fn.restype is not ctypes.c_long:
        fn.argtypes = [_I] * len(dims)
        fn.restype = ctypes.c_long
    return fn(*dims)


def conv_stack_fwd(x, w0, bias0, gt0, bt0, ups: Sequence[Upper], seed: Seed,
                   pools: Sequence[int], eps: float, relu: bool,
                   drops: Sequence[float], residuals: bool = True):
    """(out, idx0, stats0, ypool0, per upper layer (input h, idx, stats, y)):
    K6f and K7f on a CUDA tensor (without `residuals`, for inference, none
    of idx, stats, y, ypool0 and the inputs are kept: each upper layer's
    epilogue normalises its pooled value in place), the plain version on
    CPU (ypool0 None: its backward recomputes layer 0's pooled value).
    Builds no autograd graph: `ConvStack` is the differentiable entry."""
    global launches
    geo = _geometry(x, w0, bias0, gt0, bt0, ups, pools, drops)
    seed = _seed_of(seed, drops, x.device)
    if x.device.type == "cpu":
        out, idx0, stats0, res = conv_stack_ref(x, w0, bias0, gt0, bt0, ups,
                                                seed, pools, eps, relu, drops)
        return out, idx0, stats0, None, res
    z, idx0, stats0, ypool0 = conv1d.conv1d_pool_ln_act(
        x, w0, bias0, gt0, bt0, 0 if seed is None else seed, pools[0], eps,
        relu, drops[0], residuals)
    fn = _launch.entry(SOURCE, "stack_upper_fwd",
                       [_P] * 11 + [_I] * 7 + [_U, _F, _I, _U, _F, _I])
    N = x.shape[0]
    f32 = dict(device=x.device, dtype=torch.float32)
    res = []
    for i, (w, b, g, be) in enumerate(ups, 1):
        lin, K, P, ct, M = geo[i]
        C, O = z.shape[2], w.shape[0]
        _launch.check_tensors(
            "conv_stack_fwd", h=(z, (N, lin, C), torch.float32),
            kernel=(w, (O, C, K), torch.float32), bias=(b, (O,), torch.float32),
            gamma=(g, (M, O), torch.float32), beta=(be, (M, O), torch.float32))
        out = torch.empty((N, M, O), **f32)
        y, idx, stats = out, None, None
        if residuals:
            y = torch.empty((N, M, O), **f32)
            idx = torch.empty((N, M, O), device=x.device, dtype=torch.int8)
            stats = torch.empty((N, 2, O), **f32)
        scratch = torch.empty(
            _scratch(SOURCE, "stack_upper_fwd", C, K, O), **f32)
        threshold, scale, on = conv1d._drop_args(drops[i])
        _launch.call("stack_upper_fwd", fn, x.device,
                     (z.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                      be.data_ptr(), conv1d._ptr(seed if on else None),
                      y.data_ptr(), out.data_ptr(), conv1d._ptr(idx),
                      conv1d._ptr(stats), scratch.data_ptr(), N, lin, C, K, O,
                      P, M, i * SALT, eps, int(relu), threshold, scale, on),
                     f"layer {i}: N={N}, lin={lin}, C={C}, K={K}, O={O}, "
                     f"pool={P}")
        res.append((z, idx, stats, y) if residuals else (None,) * 4)
        z = out
    launches += 1
    return z, idx0, stats0, ypool0, tuple(res)


def _check_y(y, shape) -> None:
    """A pooled value given to the plain backward must be a float32 (N, M,
    O) tensor."""
    if (not isinstance(y, torch.Tensor) or tuple(y.shape) != tuple(shape)
            or y.dtype != torch.float32):
        got = (f"{tuple(y.shape)} {y.dtype}" if isinstance(y, torch.Tensor)
               else repr(y))
        raise ValueError(f"conv_stack_bwd: an upper layer's pooled value y "
                         f"must be float32 {tuple(shape)}, got {got}")


def conv_stack_bwd(x, w0, bias0, gt0, bt0, ups: Sequence[Upper], seed: Seed,
                   idx0, stats0, ypool0, ups_res: Sequence[UpperRes], dz,
                   pools: Sequence[int], eps: float, relu: bool,
                   drops: Sequence[float], need_dx: bool = True):
    """(dx, dw0, dbias0, dgt0, dbt0, per upper layer (dW, dbias, dgamma,
    dbeta)): K7b and K6b on CUDA tensors (every dbias the exact zero; K7b
    reads each upper layer's y, K6b ypool0), the plain version on CPU
    (which takes no ypool0, and recomputes a y that is None); dx is None
    without `need_dx`.  On CPU a y of the wrong shape or dtype raises
    ValueError; on the card every residual is checked before its layer's
    launch (a missing or misshapen one raises ValueError, a wrong dtype
    TypeError)."""
    global bwd_launches
    geo = _geometry(x, w0, bias0, gt0, bt0, ups, pools, drops)
    N = x.shape[0]
    seed = _seed_of(seed, drops, x.device)
    if x.device.type == "cpu":
        for i, r in enumerate(ups_res, 1):
            if r[3] is not None:
                _check_y(r[3], (N, geo[i][4], ups[i - 1][0].shape[0]))
        *grads0, dups = conv_stack_bwd_ref(x, w0, bias0, gt0, bt0, ups, seed,
                                           idx0, stats0, ups_res, dz, pools,
                                           eps, relu, drops)
        return ((grads0[0] if need_dx else None), *grads0[1:], dups)
    fn = _launch.entry(BWD_SOURCE, "stack_upper_bwd",
                       [_P] * 12 + [_I] * 7 + [_U, _F, _I, _U, _F, _I])
    f32 = dict(device=x.device, dtype=torch.float32)
    # one scratch buffer for every layer (stream-ordered reuse), and the
    # zero dbias of every layer in one tensor
    scratch = torch.empty(max(
        _scratch(BWD_SOURCE, "stack_upper_bwd", N, u[0].shape[1],
                 u[0].shape[2], u[0].shape[0], geo[i][2], geo[i][4])
        for i, u in enumerate(ups, 1)), **f32)
    dbias = torch.zeros(sum(u[1].numel() for u in ups), **f32).split(
        [u[1].numel() for u in ups])
    d = dz
    dups = []
    for i in range(len(ups), 0, -1):
        w, b, g, be = ups[i - 1]
        h, idx, stats, y = ups_res[i - 1]
        lin, K, P, ct, M = geo[i]
        C, O = w.shape[1], w.shape[0]
        _launch.check_tensors(
            "conv_stack_bwd", h=(h, (N, lin, C), torch.float32),
            kernel=(w, (O, C, K), torch.float32),
            gamma=(g, (M, O), torch.float32), beta=(be, (M, O), torch.float32),
            idx=(idx, (N, M, O), torch.int8),
            stats=(stats, (N, 2, O), torch.float32),
            y=(y, (N, M, O), torch.float32), dz=(d, (N, M, O), torch.float32))
        # scratch: the pooled gradient (first), dconv, the per-window terms
        # of dW, dgamma and dbeta, the flipped weights; the entry writes
        # dW, dgamma and dbeta one after the other
        dh = torch.empty((N, lin, C), **f32)
        grads = torch.empty(O * C * K + 2 * M * O, **f32)
        dw, dg, dbe = (part.view(t.shape) for part, t in zip(
            grads.split([O * C * K, M * O, M * O]), (w, g, be)))
        threshold, scale, on = conv1d._drop_args(drops[i])
        _launch.call("stack_upper_bwd", fn, x.device,
                     (h.data_ptr(), w.data_ptr(), g.data_ptr(), be.data_ptr(),
                      conv1d._ptr(seed if on else None), idx.data_ptr(),
                      stats.data_ptr(), y.data_ptr(), d.data_ptr(),
                      scratch.data_ptr(), dh.data_ptr(), grads.data_ptr(), N,
                      lin, C, K, O, P, M,
                      i * SALT, eps, int(relu), threshold, scale, on),
                     f"layer {i}: N={N}, lin={lin}, C={C}, K={K}, O={O}, "
                     f"pool={P}")
        dups.append((dw, dbias[i - 1], dg, dbe))
        d = dh
    grads0 = conv1d.conv1d_pool_ln_act_bwd(
        x, w0, bias0, gt0, bt0, 0 if seed is None else seed, idx0, stats0,
        ypool0, d, pools[0], eps, relu, drops[0], need_dx)
    bwd_launches += 1
    return (*grads0, tuple(reversed(dups)))


def _unflatten(flat, n: int):
    return tuple(tuple(flat[i:i + n]) for i in range(0, len(flat), n))


class ConvStack(torch.autograd.Function):
    """out = the stack, with K7b (and K6b) as its gradient; saves the
    inputs, the forward's idx and stats of every layer, layer 0's pooled
    value, and each upper layer's input and pooled value (four residuals an
    upper layer).  The upper layers' tensors come flattened after the
    static arguments, four per layer."""

    @staticmethod
    def forward(ctx, x, w0, bias0, gt0, bt0, seed, pools, eps, relu, drops,
                *ups_flat):
        ups = _unflatten(ups_flat, 4)
        out, idx0, stats0, ypool0, res = conv_stack_fwd(
            x, w0, bias0, gt0, bt0, ups, seed, pools, eps, relu, drops)
        seed_t = seed if isinstance(seed, torch.Tensor) else torch.tensor(seed)
        ctx.save_for_backward(x, w0, bias0, gt0, bt0, seed_t, idx0, stats0,
                              ypool0, *ups_flat, *(t for r in res for t in r))
        ctx.args = (pools, eps, relu, drops)
        ctx.n_flat = len(ups_flat)
        return out

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        first = saved[:9]
        ups = _unflatten(saved[9:9 + ctx.n_flat], 4)
        res = _unflatten(saved[9 + ctx.n_flat:], 4)
        *grads0, dups = conv_stack_bwd(*first[:5], ups, *first[5:], res,
                                       dz.contiguous(), *ctx.args,
                                       ctx.needs_input_grad[0])
        return (*grads0, None, None, None, None, None,
                *(t for u in dups for t in u))


def conv_stack_fused(x, w0, bias0, gt0, bt0, ups: Sequence[Upper], seed: Seed,
                     pools: Sequence[int], eps: float, relu: bool,
                     drops: Sequence[float]) -> torch.Tensor:
    """The stack, (N, M_last, O_last): differentiable (`ConvStack`) where a
    gradient is wanted, else the forward alone, which then keeps none of
    the residuals.  `seed` is an int or an int32 scalar tensor (read on the
    card by the kernels); `pools` and `drops` have one entry per layer."""
    ups = tuple(tuple(t.contiguous() for t in u) for u in ups)
    x, w0, bias0, gt0, bt0 = (t.contiguous() for t in (x, w0, bias0, gt0, bt0))
    flat = [t for u in ups for t in u]
    pools, drops = tuple(pools), tuple(float(d) for d in drops)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w0, bias0, gt0, bt0, *flat)):
        return ConvStack.apply(x, w0, bias0, gt0, bt0, seed, pools, eps, relu,
                               drops, *flat)
    return conv_stack_fwd(x, w0, bias0, gt0, bt0, ups, seed, pools, eps, relu,
                          drops, residuals=False)[0]
