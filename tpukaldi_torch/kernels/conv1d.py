"""Layer 0 of the raw-waveform front-ends: a valid single-channel 1-D conv
and max-pool (K5), and the same fused with bias, layer norm over pooled time,
relu and hash-mask dropout (K6): the hand-written CUDA kernels, forward and
backward, and their plain PyTorch versions, in float32.

    conv  c[n, s, o] = sum_k x[n, s + k] * w[k, o]        s < L - K + 1
    pool  y[n, m, o] = max_q c[n, m*pool + q, o]          m < M = (L-K+1)//pool
          idx[n, m, o] = the first q that reaches the max (int8)

K6 continues from y + bias: per (window, filter) the mean and the unbiased
std over the M pooled rows, z = ((y - mu) * r) * gt + bt with r = 1/(std +
eps) (eps on the std, the reference's layer norm), then relu and inverted
dropout whose mask is a counter hash of (seed, window, element), so the
backward rebuilds it bit for bit (`drop_mask`).

`ConvPool` and `ConvPoolLnAct` are the counterparts of tpukaldi's
`kernels/conv1d.py::conv1d_pool` and `conv1d_pool_ln_act` (each a
`jax.custom_vjp`); their backwards compute dx only where x needs a
gradient (a waveform fed in as it is does not; the raw recipes' input layer
norm, whose gain and shift train, does).  On a CUDA tensor their forwards launch
`csrc/conv_pool_fwd.cu` (K5f) and `csrc/conv_ln_fwd.cu` (K6f), their
backwards `csrc/conv_pool_bwd.cu` (K5b) and `csrc/conv_ln_bwd.cu` (K6b), or
raise; on a CPU tensor they run the plain versions (`*_ref`), which follow
tpukaldi's `_xla_conv_pool`, `_xla_conv_pool_ln_act` and the Pallas
kernels' backward arithmetic.  The layouts are tpukaldi's: x (N, L), w (K,
O), outputs (N, M, O), the affine maps gt and bt (M, O), stats (N, 2, O) =
(mean, std).  dbias is an exact zero: the layer norm's mean cancels the
bias.  In training K6f also keeps the pooled conv value before the bias,
`ypool` (N, M, O), which K6b reads instead of recomputing it (the plain
backward recomputes it through idx, as tpukaldi's does).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build, _launch

SOURCE = "conv_pool_fwd.cu"
BWD_SOURCE = "conv_pool_bwd.cu"
LN_SOURCE = "conv_ln_fwd.cu"
LN_BWD_SOURCE = "conv_ln_bwd.cu"

# The envelope of K5 and K6, on every device (csrc/conv_tile.cuh's
# kMaxTaps and kMaxPool): filters of up to 32 ms at 16 kHz (SincNet's
# published 251 taps, 25-ms 401-tap filters), pools of up to 32 conv
# positions.  tpukaldi's 129 is its TPU's (one 128-tap MXU pass and a
# rank-1 epilogue tap); the Hopper kernels loop over the taps.
MAX_K = 512
MAX_POOL = 32
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use

# kernel launches since the last reset (one per wrapper call that launched);
# chip_smoke.py reads them to show that the main path went through the
# kernels
launches = 0
bwd_launches = 0
ln_launches = 0
ln_bwd_launches = 0

Seed = Union[int, torch.Tensor]
_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------- plain
def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, L) x (K, O) -> the valid conv (N, L - K + 1, O)."""
    return F.conv1d(x[:, None, :], w.t()[:, None, :]).transpose(1, 2)


def _pool_argmax(c: torch.Tensor, pool: int):
    """Max over windows of `pool` conv rows, stride `pool`, the tail dropped,
    and the first index that reaches it (tpukaldi's `_fwd_kernel`)."""
    N, Lc, O = c.shape
    M = Lc // pool
    parts = c[:, :M * pool].reshape(N, M, pool, O).unbind(2)
    m = parts[0]
    for part in parts[1:]:
        m = torch.maximum(m, part)
    idx = torch.full(m.shape, pool - 1, dtype=torch.int8, device=c.device)
    for i in range(pool - 2, -1, -1):
        idx = torch.where(parts[i] == m, torch.tensor(i, dtype=torch.int8), idx)
    return m, idx


def _pooled_at(c: torch.Tensor, idx: torch.Tensor, pool: int) -> torch.Tensor:
    """The conv rows the saved argmax picks: (N, M, O)."""
    N, M, O = idx.shape
    c4 = c[:, :M * pool].reshape(N, M, pool, O)
    return c4.gather(2, idx.long()[:, :, None, :])[:, :, 0, :]


def conv1d_pool_ref(x: torch.Tensor, w: torch.Tensor,
                    pool: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, L), w (K, O) -> (y (N, M, O), idx (N, M, O) int8)."""
    return _pool_argmax(_conv(x, w), pool)


def conv1d_pool_bwd_ref(x: torch.Tensor, dy: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, pool: int, need_dx: bool = True
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The pooled gradient dy (N, M, O) scattered through the saved argmax
    onto the conv rows (tpukaldi's `_pool_scatter`), then the conv's
    gradients: (dx (N, L), or None without `need_dx`, dw (K, O))."""
    N, L = x.shape
    K, O = w.shape
    M = dy.shape[1]
    dconv = dy.new_zeros((N, L - K + 1, O))
    dconv[:, :M * pool].view(N, M, pool, O).scatter_(
        2, idx.long()[:, :, None, :], dy[:, :, None, :])
    wt = w.t()[:, None, :].contiguous()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dconv.transpose(1, 2).contiguous(), x[:, None, :], wt, None, [1], [0],
        [1], False, [0], 1, [need_dx, True, False])
    return (dx[:, 0, :] if need_dx else None), dw[:, 0, :].t()


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32): in two 16-bit halves of c,
    so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def keep_threshold(drop: float) -> int:
    """tpukaldi's uint32 keep threshold for rate `drop` (Python's round, as
    tpukaldi computes it)."""
    return min(int(round((1.0 - drop) * 2.0 ** 32)), 2 ** 32 - 1)


def drop_scale(drop: float) -> torch.Tensor:
    """1 / (1 - drop) rounded to float32, the factor of a kept element."""
    return torch.tensor(1.0 / (1.0 - drop), dtype=torch.float32)


def drop_mask(seed: Seed, window_id, M: int, O: int,
              drop: float) -> torch.Tensor:
    """tpukaldi's `_drop_mask` bit for bit: murmur3's fmix32 over the element
    id m*O + o, xor the int32 seed and the window id each times a constant,
    all in wrapping uint32 arithmetic; keep where the hash is below
    `keep_threshold(drop)`.  `window_id` is an int or an integer tensor (the
    window's row in the call); the mask has its shape + (M, O), on its
    device."""
    wid = torch.as_tensor(window_id, dtype=torch.int64)
    device = wid.device
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    eid = (torch.arange(M, dtype=torch.int64, device=device)[:, None] * O
           + torch.arange(O, dtype=torch.int64, device=device)) & _M32
    wid = _mul32(wid & _M32, 0x85EBCA77)[..., None, None]
    h = _mul32(eid, 0xC2B2AE3D) ^ _mul32(seed & _M32, 0x9E3779B1) ^ wid
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h < keep_threshold(drop)


def _dropout(z: torch.Tensor, seed: Seed, drop: float) -> torch.Tensor:
    N, M, O = z.shape
    mask = drop_mask(seed, torch.arange(N, device=z.device), M, O, drop)
    return torch.where(mask, z * drop_scale(drop).to(z.device), 0.0)


def conv1d_pool_ln_act_ref(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, gt: torch.Tensor,
    bt: torch.Tensor, seed: Seed, pool: int, eps: float, relu: bool,
    drop: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, L), w (K, O), bias (O,), gt and bt (M, O), the int32 dropout
    seed -> (out (N, M, O), idx (N, M, O) int8, stats (N, 2, O))."""
    m, idx = _pool_argmax(_conv(x, w), pool)
    y = m + bias
    M = y.shape[1]
    mu = y.sum(1, keepdim=True) / M
    c = y - mu
    s = torch.sqrt((c * c).sum(1, keepdim=True) / max(M - 1, 1))
    r = 1.0 / (s + eps)
    z = (c * r) * gt + bt
    if relu:
        z = torch.relu(z)
    if drop > 0.0:
        z = _dropout(z, seed, drop)
    return z, idx, torch.cat([mu, s], dim=1)


def conv1d_pool_ln_act_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, gt: torch.Tensor,
    bt: torch.Tensor, seed: Seed, idx: torch.Tensor, stats: torch.Tensor,
    dz: torch.Tensor, pool: int, eps: float, relu: bool, drop: float,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of `conv1d_pool_ln_act_ref` as tpukaldi's
    `_fused_bwd_kernel` computes it: the pooled pre-norm activation
    recomputed through idx, the dropout mask and the relu gate rebuilt, the
    layer norm's backward per window with s floored at 1e-30, then the
    conv-pool backward.  -> (dx, or None without `need_dx`, dw, dbias
    (exact 0), dgt, dbt)."""
    y = _pooled_at(_conv(x, w), idx, pool) + bias
    M = y.shape[1]
    mu, s = stats[:, 0:1], stats[:, 1:2]
    r = 1.0 / (s + eps)
    c = y - mu
    xhat = c * r
    if drop > 0.0:
        dz = _dropout(dz, seed, drop)
    if relu:
        dz = torch.where(xhat * gt + bt > 0.0, dz, 0.0)
    dgt = (dz * xhat).sum(0)
    dbt = dz.sum(0)
    dzg = dz * gt
    A = dzg.sum(1, keepdim=True)
    B = (dzg * c).sum(1, keepdim=True)
    fac = (B * r * r) / (max(M - 1, 1) * s.clamp_min(1e-30))
    dy = r * dzg - c * fac - (r / M) * A
    dx, dw = conv1d_pool_bwd_ref(x, dy, idx, w, pool, need_dx)
    return dx, dw, torch.zeros_like(bias), dgt, dbt


# ----------------------------------------------------------------- kernels
def _geometry(fn: str, x: torch.Tensor, w: torch.Tensor, pool: int):
    """(N, L, K, O, M) inside the envelope (1 <= K <= MAX_K, 1 <= pool <=
    MAX_POOL, a pooled row), which the kernels and the plain versions
    share; outside it a ValueError names the limit."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{fn}: x must be (N, L) and w (K, O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, L = x.shape
    K, O = w.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{fn} supports 1 <= K <= {MAX_K}, got {K}")
    if not 1 <= pool <= MAX_POOL:
        raise ValueError(f"{fn} supports 1 <= pool <= {MAX_POOL}, got {pool}")
    if L - K + 1 < pool:
        raise ValueError(f"{fn}: pool {pool} does not fit L - K + 1 = "
                         f"{L - K + 1}")
    return N, L, K, O, (L - K + 1) // pool


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The int32 seed as a scalar on `device` (the kernels read it there,
    so a seed drawn on the card needs no copy to the host); without
    dropout the kernels read none, and get a null pointer."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(seed, dtype=torch.int32, device=device)


def _drop_args(drop: float):
    """(threshold, scale, on) as the kernels take them."""
    if drop <= 0.0:
        return 0, 1.0, 0
    return keep_threshold(drop), drop_scale(drop).item(), 1


def conv1d_pool(x: torch.Tensor, w: torch.Tensor, pool: int,
                need_idx: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, idx): K5f on a CUDA tensor (idx not written when `need_idx` is
    False), the plain version on CPU.  Builds no autograd graph: `ConvPool`
    is the differentiable entry."""
    global launches
    N, L, K, O, M = _geometry("conv1d_pool", x, w, pool)
    _launch.refuse_bf16("conv1d_pool", x, w)
    if x.device.type == "cpu":
        return conv1d_pool_ref(x, w, pool)
    _launch.check_tensors("conv1d_pool", x=(x, (N, L), torch.float32),
                          w=(w, (K, O), torch.float32))
    y = torch.empty((N, M, O), device=x.device, dtype=torch.float32)
    idx = (torch.empty((N, M, O), device=x.device, dtype=torch.int8)
           if need_idx else None)
    fn = _launch.entry(SOURCE, "conv_pool_fwd", [_P] * 4 + [_I] * 5)
    _launch.call("conv_pool_fwd", fn, x.device,
                 (x.data_ptr(), w.data_ptr(), y.data_ptr(), _ptr(idx), N, L, K,
                  O, pool), f"N={N}, L={L}, K={K}, O={O}, pool={pool}")
    launches += 1
    return y, idx


def conv1d_pool_bwd(x: torch.Tensor, dy: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor, pool: int, need_dx: bool = True
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx, dw): K5b on CUDA tensors, the plain version on CPU; dx is None,
    and its pass skipped, without `need_dx`."""
    global bwd_launches
    N, L, K, O, M = _geometry("conv1d_pool_bwd", x, w, pool)
    _launch.refuse_bf16("conv1d_pool_bwd", x, dy, w)
    if x.device.type == "cpu":
        return conv1d_pool_bwd_ref(x, dy, idx, w, pool, need_dx)
    _launch.check_tensors(
        "conv1d_pool_bwd", x=(x, (N, L), torch.float32),
        dy=(dy, (N, M, O), torch.float32), idx=(idx, (N, M, O), torch.int8),
        w=(w, (K, O), torch.float32))
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w)
    dw_part = torch.empty((N, K, O), device=x.device, dtype=torch.float32)
    fn = _launch.entry(BWD_SOURCE, "conv_pool_bwd", [_P] * 7 + [_I] * 5)
    _launch.call("conv_pool_bwd", fn, x.device,
                 (x.data_ptr(), dy.data_ptr(), idx.data_ptr(), w.data_ptr(),
                  dw_part.data_ptr(), _ptr(dx), dw.data_ptr(), N, L, K, O,
                  pool), f"N={N}, L={L}, K={K}, O={O}, pool={pool}")
    bwd_launches += 1
    return dx, dw


def _ln_smem_check(fn: str, L: int, K: int, pool: int) -> None:
    """K6f holds a window's pooled rows of 16 filters in shared memory."""
    smem = getattr(_build.load(LN_SOURCE), "tpk_conv_ln_smem_bytes")
    smem.argtypes = [_I, _I, _I]
    smem.restype = ctypes.c_long
    need = smem(L, K, pool)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{fn}: a window of L={L} (K={K}, pool={pool}) needs {need} bytes "
            f"of shared memory, more than the {SMEM_LIMIT} a block may use")


_PLAN_KEYS = {
    SOURCE: ("threads", "filters", "positions", "filters_per_thread",
             "rows", "row_blocks", "items", "grid", "smem_bytes",
             "blocks_per_sm", "buffers"),
    LN_SOURCE: ("threads", "filters", "positions", "filters_per_thread",
                "items", "grid", "smem_bytes", "blocks_per_sm", "buffers"),
}


def fwd_plan(source: str, N: int, L: int, K: int, O: int, pool: int,
             lib: Optional[ctypes.CDLL] = None) -> dict:
    """The launch of K5f (`source` SOURCE) or K6f (LN_SOURCE) at a shape,
    from its `tpk_<name>_plan` (in `lib`, the source's own build by
    default): threads a block (the long block's, or the short block's for
    a short window), filters a block tile, conv positions and filters a
    conv thread computes, items (window, tile, block of rows), grid, shared
    bytes, the blocks an SM holds and the pooled-row buffers (K5f also its
    rows an item and row blocks a window)."""
    name = source[:-3]
    fn = getattr(lib or _build.load(source), f"tpk_{name}_plan")
    fn.argtypes = [_I] * 5 + [_P]
    fn.restype = _I
    keys = _PLAN_KEYS[source]
    out = (ctypes.c_int * len(keys))()
    err = fn(N, L, K, O, pool, out)
    if err != 0:
        raise RuntimeError(f"{name}: no launch at N={N}, L={L}, K={K}, O={O}, "
                           f"pool={pool} (CUDA error {err})")
    return dict(zip(keys, out))


def conv1d_pool_ln_act(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, gt: torch.Tensor,
    bt: torch.Tensor, seed: Seed, pool: int, eps: float, relu: bool,
    drop: float = 0.0, residuals: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """(out, idx, stats, ypool): K6f on a CUDA tensor (idx, stats and the
    pooled value before the bias, ypool (N, M, O), for K6b; none of them
    written when `residuals` is False: inference needs none), the plain
    version on CPU (ypool None: the plain backward recomputes it).  `seed`
    is an int or an int32 scalar tensor (read on the card by the kernel).
    Builds no autograd graph: `ConvPoolLnAct` is the differentiable
    entry."""
    global ln_launches
    N, L, K, O, M = _geometry("conv1d_pool_ln_act", x, w, pool)
    _launch.refuse_bf16("conv1d_pool_ln_act", x, w, bias, gt, bt)
    if x.device.type == "cpu":
        seed = int(seed) if drop > 0.0 else 0
        return (*conv1d_pool_ln_act_ref(x, w, bias, gt, bt, seed, pool, eps,
                                        relu, drop), None)
    _launch.check_tensors(
        "conv1d_pool_ln_act", x=(x, (N, L), torch.float32),
        w=(w, (K, O), torch.float32), bias=(bias, (O,), torch.float32),
        gt=(gt, (M, O), torch.float32), bt=(bt, (M, O), torch.float32))
    _ln_smem_check("conv1d_pool_ln_act", L, K, pool)
    seed_t = _seed_tensor(seed, x.device) if drop > 0.0 else None
    out = torch.empty((N, M, O), device=x.device, dtype=torch.float32)
    idx = stats = ypool = None
    if residuals:
        idx = torch.empty((N, M, O), device=x.device, dtype=torch.int8)
        stats = torch.empty((N, 2, O), device=x.device, dtype=torch.float32)
        ypool = torch.empty_like(out)
    threshold, scale, on = _drop_args(drop)
    fn = _launch.entry(LN_SOURCE, "conv_ln_fwd",
                       [_P] * 10 + [_I] * 5 + [_F, _I, _U, _F, _I])
    _launch.call("conv_ln_fwd", fn, x.device,
                 (x.data_ptr(), w.data_ptr(), bias.data_ptr(), gt.data_ptr(),
                  bt.data_ptr(), _ptr(seed_t), out.data_ptr(), _ptr(idx),
                  _ptr(stats), _ptr(ypool), N, L, K, O, pool, eps, int(relu),
                  threshold, scale, on),
                 f"N={N}, L={L}, K={K}, O={O}, pool={pool}")
    ln_launches += 1
    return out, idx, stats, ypool


def conv1d_pool_ln_act_bwd(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, gt: torch.Tensor,
    bt: torch.Tensor, seed: Seed, idx: torch.Tensor, stats: torch.Tensor,
    ypool: Optional[torch.Tensor], dz: torch.Tensor, pool: int, eps: float,
    relu: bool, drop: float, need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, dw, dbias, dgt, dbt): K6b on CUDA tensors from the forward's
    residuals idx, stats and ypool (dbias the exact zero), the plain version
    on CPU (which recomputes the pooled value and takes no ypool); dx is
    None, and its pass skipped, without `need_dx`."""
    global ln_bwd_launches
    N, L, K, O, M = _geometry("conv1d_pool_ln_act_bwd", x, w, pool)
    _launch.refuse_bf16("conv1d_pool_ln_act_bwd", x, w, bias, gt, bt, dz)
    if x.device.type == "cpu":
        seed = int(seed) if drop > 0.0 else 0
        return conv1d_pool_ln_act_bwd_ref(x, w, bias, gt, bt, seed, idx,
                                          stats, dz, pool, eps, relu, drop,
                                          need_dx)
    if ypool is None:
        raise ValueError("conv1d_pool_ln_act_bwd: the kernel reads K6f's "
                         "ypool, which its forward writes with residuals")
    _launch.check_tensors(
        "conv1d_pool_ln_act_bwd", x=(x, (N, L), torch.float32),
        w=(w, (K, O), torch.float32), bias=(bias, (O,), torch.float32),
        gt=(gt, (M, O), torch.float32), bt=(bt, (M, O), torch.float32),
        idx=(idx, (N, M, O), torch.int8),
        stats=(stats, (N, 2, O), torch.float32),
        ypool=(ypool, (N, M, O), torch.float32),
        dz=(dz, (N, M, O), torch.float32))
    seed_t = _seed_tensor(seed, x.device) if drop > 0.0 else None
    f32 = dict(device=x.device, dtype=torch.float32)
    # scratch: the pooled gradient and the per-window terms of dgt and dbt
    # and of dw, summed over the windows in a second pass
    dyp, dgp, dbp = (torch.empty((N, M, O), **f32) for _ in range(3))
    dw_part = torch.empty((N, K, O), **f32)
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w)
    dgt = torch.empty_like(gt)
    dbt = torch.empty_like(bt)
    threshold, scale, on = _drop_args(drop)
    fn = _launch.entry(LN_BWD_SOURCE, "conv_ln_bwd",
                       [_P] * 18 + [_I] * 5 + [_F, _I, _U, _F, _I])
    _launch.call("conv_ln_bwd", fn, x.device,
                 (x.data_ptr(), w.data_ptr(), bias.data_ptr(), gt.data_ptr(),
                  bt.data_ptr(), _ptr(seed_t), idx.data_ptr(),
                  stats.data_ptr(), ypool.data_ptr(), dz.data_ptr(),
                  dyp.data_ptr(), dgp.data_ptr(), dbp.data_ptr(),
                  dw_part.data_ptr(), _ptr(dx), dw.data_ptr(), dgt.data_ptr(),
                  dbt.data_ptr(), N, L, K, O, pool, eps, int(relu), threshold,
                  scale, on), f"N={N}, L={L}, K={K}, O={O}, pool={pool}")
    ln_bwd_launches += 1
    return dx, dw, torch.zeros_like(bias), dgt, dbt


class ConvPool(torch.autograd.Function):
    """y = conv1d_pool(x, w, pool) with K5b as its gradient (dx only where x
    needs one); saves (x, w, idx), as tpukaldi's `_conv_pool_vjp_fwd`
    does."""

    @staticmethod
    def forward(ctx, x, w, pool):
        y, idx = conv1d_pool(x, w, pool)
        ctx.save_for_backward(x, w, idx)
        ctx.pool = pool
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dx, dw = conv1d_pool_bwd(x, dy.contiguous(), idx, w, ctx.pool,
                                 ctx.needs_input_grad[0])
        return dx, dw, None


class ConvPoolLnAct(torch.autograd.Function):
    """out = conv1d_pool_ln_act(x, w, bias, gt, bt, seed, ...) with K6b as
    its gradient (dx only where x needs one); saves (x, w, bias, gt, bt,
    seed, idx, stats), as tpukaldi's `_fused_vjp_fwd` does (no mask: the
    backward rebuilds it), and on the card K6f's ypool."""

    @staticmethod
    def forward(ctx, x, w, bias, gt, bt, seed, pool, eps, relu, drop):
        out, idx, stats, ypool = conv1d_pool_ln_act(x, w, bias, gt, bt, seed,
                                                    pool, eps, relu, drop)
        seed_t = seed if isinstance(seed, torch.Tensor) else torch.tensor(seed)
        ctx.save_for_backward(x, w, bias, gt, bt, seed_t, idx, stats, ypool)
        ctx.args = (pool, eps, relu, drop)
        return out

    @staticmethod
    def backward(ctx, dz):
        grads = conv1d_pool_ln_act_bwd(*ctx.saved_tensors, dz.contiguous(),
                                       *ctx.args, ctx.needs_input_grad[0])
        return (*grads, None, None, None, None, None)


def conv_pool(x: torch.Tensor, w: torch.Tensor, pool: int) -> torch.Tensor:
    """The differentiable K5 where a gradient is wanted, else the forward
    alone, which then writes no argmax, through its custom op
    (`ops.conv_pool`, which an exported graph holds).  bf16 inputs (the
    bf16 compute mode) are widened to float32 at this boundary and y comes
    back in x's dtype, as tpukaldi's model casts around its kernel (the
    gradients, by autograd through the casts, in the primal dtypes)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ConvPool.apply(_launch.widen(x), _launch.widen(w),
                              pool).to(x.dtype)
    from . import ops

    return ops.conv_pool(x, w, pool)


def conv_pool_ln_act(x, w, bias, gt, bt, seed: Seed, pool: int, eps: float,
                     relu: bool, drop: float = 0.0) -> torch.Tensor:
    """The differentiable K6 where a gradient is wanted, else the forward
    alone, which then writes neither idx nor stats: at drop 0 through its
    custom op (`ops.conv_pool_ln_act`, which an exported graph holds).
    bf16 inputs are widened at this boundary and the output comes back in
    x's dtype, as `conv_pool` does."""
    dtype = x.dtype
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, bias, gt, bt))) and drop == 0.0:
        from . import ops

        return ops.conv_pool_ln_act(x, w, bias, gt, bt, pool, eps, relu)
    x, w, bias, gt, bt = (_launch.widen(t) for t in (x, w, bias, gt, bt))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, bias, gt, bt)):
        return ConvPoolLnAct.apply(x, w, bias, gt, bt, seed, pool, eps, relu,
                                   drop).to(dtype)
    return conv1d_pool_ln_act(x, w, bias, gt, bt, seed, pool, eps, relu, drop,
                              residuals=False)[0].to(dtype)
