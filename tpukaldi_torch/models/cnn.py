"""Raw-waveform front-ends: CNN and SincNet (counterpart of tpukaldi's
`models/cnn.py`, reference neural_networks.py:1464-1665, SincConv
:1668-1959), and the rate-differing ones without parameters, logMelFb and
channel_averaging (:658-717; their classes at the end of this file).

Both take flat (N, samples) windows (arch_seq_model = False; the raw-wave
dump cuts 200 ms windows, `tools/save_raw_fea.py`) and return the flattened
(N, filt * time) conv features.  Each layer is a valid 1-D conv and a
max-pool (stride = width, floor), then a layer norm over time per (window,
filter) with a full (filt, time) affine map, batchnorm, the activation and
dropout, each as the cfg asks.  SincNet's layer 0 synthesises band-pass
filters from learnable cut-offs every forward, in float32.

Layer 0 (one input channel) is where the kernels are
(`kernels/conv1d.py`), chosen by `TPUKALDI_CONV_IMPL`, read once per module
and normalised (strip, lower):
- `auto` (default): the kernels on a CUDA tensor, the composed path on a CPU
  one, which is what tpukaldi's `auto` does off a TPU;
- `pallas`: the kernel functions, which on a CPU tensor run their plain
  versions;
- `nhc`, `dot`, `xla`: the composed path (`F.conv1d`, pool, the separate
  layer norm, activation and dropout).
Any other value raises.  With the kernels, layer 0 runs K6 (conv, pool,
bias, layer norm, relu and dropout in one) where it has a layer norm, no
batchnorm and a relu or linear activation, else K5 (conv and pool).  K6's
dropout in training takes an int32 seed drawn from the step's generator, so
a replayed chunk drops the same elements.  Layers 1-3 (C > 1) run `F.conv1d`,
as tpukaldi runs them outside any Pallas kernel.  Activations stay (N, C,
time) between layers, the reference's layout.

The state_dict keeps the reference layout (tpukaldi's
`compat/torch_import.py:116-154`): `ln0`/`bn0` on the input, `conv.{i}`
(Conv1d weight (out, in, K) and bias; SincNet's `conv.0.low_hz_` and
`band_hz_`), `ln.{i}` (gamma and beta (filt, time)), `bn.{i}`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import to_bool
from ..kernels.conv1d import conv_pool, conv_pool_ln_act
from .common import (
    RefLayerNorm,
    act_fun,
    batchnorm,
    bool_list,
    float_list,
    int_list,
    inverted_dropout,
    ref_laynorm,
    torch_linear_uniform,
)

CONV_IMPLS = ("auto", "pallas", "nhc", "dot", "xla")


def conv_impl() -> str:
    """`TPUKALDI_CONV_IMPL`, normalised; an unknown value raises."""
    impl = os.environ.get("TPUKALDI_CONV_IMPL", "auto").strip().lower()
    if impl not in CONV_IMPLS:
        raise ValueError(f"TPUKALDI_CONV_IMPL={impl!r} is not one of "
                         f"{', '.join(CONV_IMPLS)}")
    return impl


class CNNLayerNorm(nn.Module):
    """The reference LayerNorm with a (filt, time) shape
    (neural_networks.py:1510-1512): over the last axis (time) of (N, filt,
    time), unbiased std, eps on the std, the affine map over the whole
    (filt, time) plane."""

    def __init__(self, n_filt: int, n_time: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(n_filt, n_time, device=device))
        self.beta = nn.Parameter(torch.zeros(n_filt, n_time, device=device))
        self.eps = eps

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return ref_laynorm(x, self.gamma, self.beta, self.eps)


def _to_mel(hz):
    return 2595 * np.log10(1 + hz / 700)


def _to_hz(mel):
    return 700 * (10 ** (mel / 2595) - 1)


def sinc_filters_fast(low_hz_, band_hz_, kernel_size: int, sample_rate: int,
                      min_low_hz: float, min_band_hz: float) -> torch.Tensor:
    """Band-pass filters by the half-window symmetry of SincConv_fast
    (neural_networks.py:1915-1949): (out_channels, kernel_size)."""
    dev = low_hz_.device
    dt = low_hz_.dtype
    half = (kernel_size - 1) // 2
    n_lin = torch.linspace(0, kernel_size / 2 - 1, int(kernel_size / 2),
                           dtype=dt, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel_size)
    n_ = 2 * math.pi * torch.arange(-half, 0.0, dtype=dt,
                                    device=dev)[None, :] / sample_rate
    low = min_low_hz + torch.abs(low_hz_)
    # jnp.clip as tpukaldi has it: maximum then minimum, whose gradient
    # splits in half at a bound (torch.clamp passes it whole); the mel init
    # puts the last filter's high edge exactly at sample_rate / 2
    high = low + min_band_hz + torch.abs(band_hz_)
    high = torch.minimum(torch.maximum(high, high.new_full((), min_low_hz)),
                         high.new_full((), sample_rate / 2))
    band = (high - low)[:, 0]
    f_low = low @ n_
    f_high = high @ n_
    bp_left = ((torch.sin(f_high) - torch.sin(f_low)) / (n_ / 2)) * window
    bp_center = 2 * band[:, None]
    bp_right = torch.flip(bp_left, dims=(1,))
    band_pass = torch.cat([bp_left, bp_center, bp_right], dim=1)
    return band_pass / (2 * band[:, None])


def sinc_filters_slow(low_hz_, band_hz_, kernel_size: int, sample_rate: int,
                      min_low_hz: float, min_band_hz: float) -> torch.Tensor:
    """The original SincConv's filters, normalised frequencies and max-norm
    (neural_networks.py:1789-1803): (out_channels, kernel_size)."""
    dev = low_hz_.device
    dt = low_hz_.dtype
    half = (kernel_size - 1) // 2
    n_lin = torch.linspace(0, kernel_size, kernel_size, dtype=dt, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel_size)
    n_ = torch.arange(-half, half + 1.0, dtype=dt,
                      device=dev)[None, :] / sample_rate

    def stable_sinc(x):
        y_left = torch.sin(x[:, :half]) / x[:, :half]
        ones = torch.ones((x.shape[0], 1), dtype=dt, device=dev)
        return torch.cat([y_left, ones, torch.flip(y_left, dims=(1,))], dim=1)

    low = min_low_hz / sample_rate + torch.abs(low_hz_)
    high = low + min_band_hz / sample_rate + torch.abs(band_hz_)
    lp1 = 2 * low * stable_sinc(2 * math.pi * (low @ n_) * sample_rate)
    lp2 = 2 * high * stable_sinc(2 * math.pi * (high @ n_) * sample_rate)
    band_pass = lp2 - lp1
    band_pass = band_pass / band_pass.max(dim=1, keepdim=True).values
    return band_pass * window


class SincConv(nn.Module):
    """SincNet's layer 0: learnable cut-offs (`low_hz_`, `band_hz_`, each
    (out_channels, 1)) from which the band-pass filters are synthesised in
    float32 every forward; mel-spaced at init.  The default is the original
    SincConv (normalised frequencies, the reference's SincNet);
    `sinc_fast = True` the half-window variant, whose cut-offs are in Hz."""

    def __init__(self, options: Dict[str, str], n_filt: int, len_filt: int,
                 device=None):
        super().__init__()
        o = options
        self.sample_rate = int(o.get("sinc_sample_rate", 16000))
        self.min_low_hz = int(o.get("sinc_min_low_hz", 50))
        self.min_band_hz = int(o.get("sinc_min_band_hz", 50))
        self.fast = to_bool(o.get("sinc_fast", "False"))
        self.kernel_size = len_filt + 1 if len_filt % 2 == 0 else len_filt
        self.n_filt = n_filt
        self.low_hz_ = nn.Parameter(torch.zeros(n_filt, 1, device=device))
        self.band_hz_ = nn.Parameter(torch.zeros(n_filt, 1, device=device))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        high_hz = self.sample_rate / 2 - (self.min_low_hz + self.min_band_hz)
        mel = np.linspace(_to_mel(30), _to_mel(high_hz), self.n_filt + 1)
        hz = _to_hz(mel)
        if not self.fast:
            hz = hz / self.sample_rate
        with torch.no_grad():
            self.low_hz_.copy_(torch.from_numpy(hz[:-1, None]))
            self.band_hz_.copy_(torch.from_numpy(np.diff(hz)[:, None]))

    def filters(self) -> torch.Tensor:
        synth = sinc_filters_fast if self.fast else sinc_filters_slow
        return synth(self.low_hz_.float(), self.band_hz_.float(),
                     self.kernel_size, self.sample_rate, self.min_low_hz,
                     self.min_band_hz).to(self.low_hz_.dtype)

    def kernel(self):
        """Layer 0's (out, 1, K) weight and its bias (none)."""
        return self.filters()[:, None, :], None


class _ConvStack(nn.Module):
    """The CNN and SincNet scaffold; subclasses set PREFIX and make layer 0
    (`first_layer`, a module whose `kernel()` gives the (O, 1, K) weight and
    the bias or None)."""

    PREFIX = "cnn"

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options = options
        self.inp_dim = inp_dim
        o, p = options, self.PREFIX
        self.n_filt, self.len_filt, self.pool, time = self._dims(options,
                                                                 inp_dim)
        self.acts = o[f"{p}_act"].split(",")
        self.drop = float_list(o[f"{p}_drop"])
        self.use_ln = bool_list(o[f"{p}_use_laynorm"])
        self.use_bn = bool_list(o[f"{p}_use_batchnorm"])
        self.impl = conv_impl()
        if to_bool(o.get(f"{p}_use_laynorm_inp", "False")):
            self.ln0 = RefLayerNorm(inp_dim, device=device)
        if to_bool(o.get(f"{p}_use_batchnorm_inp", "False")):
            self.bn0 = batchnorm(inp_dim, device=device)
        self.conv = nn.ModuleList()
        self.ln = nn.ModuleList()
        self.bn = nn.ModuleList()
        for i, (n, k, t) in enumerate(zip(self.n_filt, self.len_filt, time)):
            self.conv.append(
                self.first_layer(n, k, device) if i == 0 else
                nn.Conv1d(self.n_filt[i - 1], n, k, device=device))
            # Identity placeholders keep the reference's per-layer indices
            # without adding state_dict entries for unused norms
            self.ln.append(CNNLayerNorm(n, t, device=device)
                           if self.use_ln[i] else nn.Identity())
            self.bn.append(batchnorm(n, device=device)
                           if self.use_bn[i] else nn.Identity())

    @classmethod
    def _dims(cls, options, inp_dim):
        """Filters, widths, pools and each layer's pooled time.  The
        reference's float-then-truncate `int((current - K + 1) / pool)`,
        with the cfg's width even where SincConv pads an even one."""
        p = cls.PREFIX
        n_filt = int_list(options[f"{p}_n_filt"])
        len_filt = int_list(options[f"{p}_len_filt"])
        pool = int_list(options[f"{p}_max_pool_len"])
        time, current = [], inp_dim
        for k, q in zip(len_filt, pool):
            current = int((current - k + 1) / q)
            time.append(current)
        return n_filt, len_filt, pool, time

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        n_filt, _, _, time = cls._dims(options, inp_dim)
        return time[-1] * n_filt[-1]

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def first_layer(self, n_filt: int, len_filt: int, device) -> nn.Module:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        """nn.Conv1d's default init, U(+-1/sqrt(in * K)), for weights and
        biases, drawn from `generator`; SincConv's mel init; norms to their
        identity."""
        with torch.no_grad():
            for conv in self.conv:
                if isinstance(conv, SincConv):
                    conv.reset_parameters()
                    continue
                fan_in = conv.weight.shape[1] * conv.weight.shape[2]
                conv.weight.copy_(torch_linear_uniform(conv.weight.shape,
                                                       fan_in, generator))
                conv.bias.copy_(torch_linear_uniform(conv.bias.shape, fan_in,
                                                     generator))
        for m in (*self.ln, *self.bn, getattr(self, "ln0", None),
                  getattr(self, "bn0", None)):
            if isinstance(m, (RefLayerNorm, CNNLayerNorm, nn.BatchNorm1d)):
                m.reset_parameters()

    def _kernels(self, x: torch.Tensor) -> bool:
        return self.impl == "pallas" or (self.impl == "auto"
                                         and x.device.type == "cuda")

    def _fused0(self) -> bool:
        return (self.use_ln[0] and not self.use_bn[0]
                and self.acts[0] in ("relu", "linear"))

    def _dropout(self, x, i, generator):
        return inverted_dropout(x, self.drop[i], self.training, generator)

    def _layer0(self, x, generator):
        """Layer 0 through the kernels: (N, L) -> (N, filt, time), and
        whether the layer norm, activation and dropout are done."""
        w, bias = self.conv[0].kernel()
        # (K, O) in x's dtype: SincConv's float32 filters are cast down as
        # tpukaldi casts them; the kernels' entries widen a bf16 x, w and
        # affine maps at their boundary and return x's dtype
        w2d = w[:, 0, :].t().to(x.dtype).contiguous()
        pool = self.pool[0]
        if not self._fused0():
            y = conv_pool(x, w2d, pool).transpose(1, 2)
            return (y if bias is None else y + bias[None, :, None]), False
        ln = self.ln[0]
        b0 = bias if bias is not None else w2d.new_zeros(w2d.shape[1])
        drop, seed = 0.0, 0
        if self.training and self.drop[0] > 0.0:
            drop = self.drop[0]
            seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=generator,
                                 device=x.device, dtype=torch.int32)
        z = conv_pool_ln_act(x, w2d, b0, ln.gamma.t().contiguous(),
                             ln.beta.t().contiguous(), seed, pool, ln.eps,
                             self.acts[0] == "relu", drop)
        return z.transpose(1, 2), True

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if hasattr(self, "ln0"):
            x = self.ln0(x)
        if hasattr(self, "bn0"):
            x = self.bn0(x)
        N = x.shape[0]
        for i in range(len(self.n_filt)):
            done = False
            if i == 0 and self._kernels(x):
                x, done = self._layer0(x.contiguous(), generator)
            else:
                w, bias = (self.conv[0].kernel() if i == 0 else
                           (self.conv[i].weight, self.conv[i].bias))
                x = F.conv1d(x[:, None, :] if i == 0 else x, w.to(x.dtype),
                             bias)
                if self.pool[i] > 1:
                    x = F.max_pool1d(x, self.pool[i])
            if done:
                continue
            x = self.ln[i](x)
            if self.use_bn[i]:
                # torch BatchNorm1d on (N, C, L): per-channel statistics over
                # N and L
                C, T = x.shape[1], x.shape[2]
                x = self.bn[i](x.transpose(1, 2).reshape(-1, C)).reshape(
                    N, T, C).transpose(1, 2)
            x = act_fun(self.acts[i])(x)
            x = self._dropout(x, i, generator)
        # the reference flattens (N, filt, time)
        return x.reshape(N, -1)


class _Conv0(nn.Conv1d):
    """CNN's layer 0: a plain Conv1d over one input channel."""

    def kernel(self):
        return self.weight, self.bias


class CNN(_ConvStack):
    """Plain conv stack over raw samples (neural_networks.py:1464)."""

    PREFIX = "cnn"

    def first_layer(self, n_filt, len_filt, device):
        return _Conv0(1, n_filt, len_filt, device=device)


class SincNet(_ConvStack):
    """Conv stack whose layer 0 is a SincConv (neural_networks.py:1559); the
    original SincConv by default, as the reference's SincNet hardwires it,
    `sinc_fast = True` for the half-window variant (other cut-off units,
    not checkpoint-compatible with the default)."""

    PREFIX = "sinc"

    def first_layer(self, n_filt, len_filt, device):
        return SincConv(self.options, n_filt, len_filt, device=device)


def _mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular HTK-scale mel filterbank, (n_fft//2+1, n_mels), float64
    (tpukaldi's `models/cnn.py::_mel_filterbank`)."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_to_mel(0.0), _to_mel(sample_rate / 2), n_mels + 2)
    hz_pts = _to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, ce, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ce - lo, 1e-10)
        down = (hi - freqs) / max(hi - ce, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def refuse_bf16_input(x: torch.Tensor, class_name: str) -> None:
    """A front end that has no bf16 compute mode raises on a bf16 input
    (`train/step.py::refuse_bf16_front_ends` refuses such a run first)."""
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{class_name} has no {x.dtype} compute mode: tpukaldi's fails "
            "in it; run the front end in float32")


class logMelFb(nn.Module):
    """On-the-fly log-mel front end (reference neural_networks.py:658-699,
    tpukaldi's `models/cnn.py::logMelFb`): (samples, B, 1) -> (frames, B,
    n_mels), frames = 1 + (samples - window) // shift.  Frames without
    centring, a periodic Hann window 0.5 - 0.5 cos(2 pi n / window), the
    power spectrum of `torch.fft.rfft`, the mel filterbank, log10 of the
    energies clamped at 1e-20.  The spectrum runs in float32 (float64 for a
    float64 input); the output returns in the caller's dtype.  No
    parameters."""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        o = options
        self.options, self.inp_dim = options, inp_dim
        self.sample_rate = int(o.get("logmelfb_nr_sample_rate", 16000))
        self.n_mels = int(o["logmelfb_nr_filt"])
        self.win = int(o["logmelfb_stft_window_size"])
        self.hop = int(o["logmelfb_stft_window_shift"])
        # a buffer, not a state_dict entry: it moves with the module and
        # needs no host copy in a step (a captured one cannot make one)
        self.register_buffer("fb", torch.from_numpy(_mel_filterbank(
            self.sample_rate, self.win, self.n_mels)).to(device),
            persistent=False)

    @staticmethod
    def compute_out_dim(options: Dict[str, str], inp_dim: int) -> int:
        return int(options["logmelfb_nr_filt"])

    @property
    def out_dim(self) -> int:
        return self.n_mels

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward(self, x: torch.Tensor, generator=None, lengths=None):
        refuse_bf16_input(x, "logMelFb")
        if x.shape[-1] != 1:
            raise ValueError(f"logMelFb takes one channel, got {x.shape[-1]}")
        dt = torch.float64 if x.dtype == torch.float64 else torch.float32
        signal = x[..., 0].t().to(dt)  # (B, samples)
        # frame t is samples [t * hop, t * hop + win): tpukaldi's index
        # arithmetic, as a view
        frames = signal.unfold(1, self.win, self.hop)  # (B, frames, win)
        n = torch.arange(self.win, dtype=dt, device=x.device)
        window = 0.5 - 0.5 * torch.cos(2 * math.pi * n / self.win)
        spec = torch.fft.rfft(frames * window, n=self.win, dim=-1)
        power = spec.abs() ** 2  # (B, frames, win // 2 + 1)
        mel = power @ self.fb.to(dt)
        log_mel = torch.log10(torch.clamp_min(mel, 1e-20))
        return log_mel.transpose(0, 1).to(x.dtype)


class channel_averaging(nn.Module):
    """Fixed-weight multi-microphone average (reference
    neural_networks.py:702-717): the `chavg_channelweights` normalised to
    sum 1 in float32, then the weighted sum over the channels, (T, B, C) ->
    (T, B, 1) in the caller's dtype.  No parameters."""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options, self.inp_dim = options, inp_dim
        weights = np.array([float(v) for v in
                            options["chavg_channelweights"].split(",")],
                           dtype=np.float32)
        self.register_buffer("weights",
                             torch.from_numpy(weights / weights.sum()).to(device),
                             persistent=False)

    @staticmethod
    def compute_out_dim(options: Dict[str, str], inp_dim: int) -> int:
        return 1

    @property
    def out_dim(self) -> int:
        return 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward(self, x: torch.Tensor, generator=None, lengths=None):
        if x.shape[-1] != self.weights.shape[0]:
            raise ValueError(
                f"channel_averaging has {self.weights.shape[0]} channel "
                f"weights, its input {x.shape[-1]} channels")
        return torch.einsum("tbc,c->tb", x,
                            self.weights.to(x.dtype))[..., None]
