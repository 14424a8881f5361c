"""The PASE waveform encoder (counterpart of tpukaldi's `models/pase.py`;
reference neural_networks.py:2023-2055 wraps the external `pase` package,
tpukaldi and the port implement the encoder itself).

Architecture (PASE's front end, Pascual et al., Interspeech 2019): a
SincNet first convolution, then strided Conv1d + BatchNorm + PReLU blocks
that decimate 16 kHz samples to a 10 ms frame rate, then a 1x1 convolution
to the embedding and a BatchNorm:

    sinc(64, k=251, s=1) -> |.| -> BN -> PReLU
        -> [Conv(f_i, k_i, s_i) + BN + PReLU] x N -> Conv(emb_dim, 1) + BN

Every structural knob comes from the `pase_cfg` json (the file the
reference hands to pase's wf_builder): `emb_dim`, and optionally `fmaps`,
`kwidths`, `strides`, `sinc_out`, `sinc_kwidth`, `sample_rate`, with the
published defaults below (decimation prod(strides) = 160, 10 ms at 16 kHz).
Every convolution pads as flax's `padding="SAME"`: out = ceil(L / s), the
total max((out - 1) s + k - L, 0) split total // 2 before and the rest
after (an even kernel pads one more on the right).  The sinc filters are
`cnn.py::sinc_filters_fast` of the learnable cut-offs `low_hz`/`band_hz`
(Hz, mel-spaced from 30 Hz to sr/2 - 100 Hz at init; minimum low and band
50 Hz), synthesised in float32 every forward.  BatchNorm is tpukaldi's
(`common.py::BatchNorm`: flax's momentum 0.95, eps 1e-5, biased running
variance), PReLU per channel with slopes 0.25 at init.

The state_dict keeps tpukaldi's names: `low_hz`, `band_hz`, `sinc_bn`,
`sinc_act`, `conv.{i}` (Conv1d (out, in, k) and bias), `bn.{i}`,
`act.{i}`, `emb`, `emb_bn` (`compat/jax_params.py` maps them).  A pase
checkpoint loads through `compat/jax_params.py::convert_pase_checkpoint`;
the runtime never reads `pase_model`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .cnn import _to_hz, _to_mel, refuse_bf16_input, sinc_filters_fast
from .common import batchnorm

# PASE front-end defaults (overridable through the pase_cfg json)
DEFAULT_FMAPS = (64, 128, 128, 256, 256, 512, 512)
DEFAULT_KWIDTHS = (10, 5, 5, 5, 5, 5, 5)
DEFAULT_STRIDES = (10, 2, 2, 2, 1, 2, 1)  # x sinc stride 1 -> 160 overall
DEFAULT_SINC_OUT = 64
DEFAULT_SINC_KWIDTH = 251
MIN_LOW_HZ = MIN_BAND_HZ = 50.0

# the parsed json, keyed on (path, mtime, size, emb_dim): read once per
# experiment, and a rewritten file still reads anew
_CFG_CACHE: Dict[tuple, Dict[str, Any]] = {}


def read_pase_cfg(options: Dict[str, Any]) -> Dict[str, Any]:
    """The encoder's structure from the arch's `pase_cfg` json (none: the
    defaults and the arch's `emb_dim`, 100 without one)."""
    cfg: Dict[str, Any] = {}
    path = options.get("pase_cfg", "")
    key = None
    if path:
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size,
               options.get("emb_dim"))
        hit = _CFG_CACHE.get(key)
        if hit is not None:
            return hit
        with open(path) as f:
            cfg = json.load(f)
    out = {
        "emb_dim": int(cfg.get("emb_dim", options.get("emb_dim", 100))),
        "fmaps": tuple(cfg.get("fmaps", DEFAULT_FMAPS)),
        "kwidths": tuple(cfg.get("kwidths", DEFAULT_KWIDTHS)),
        "strides": tuple(cfg.get("strides", DEFAULT_STRIDES)),
        "sinc_out": int(cfg.get("sinc_out", DEFAULT_SINC_OUT)),
        "sinc_kwidth": int(cfg.get("sinc_kwidth", DEFAULT_SINC_KWIDTH)),
        "sample_rate": int(cfg.get("sample_rate", 16000)),
    }
    if key is not None:
        _CFG_CACHE[key] = out
    return out


def decimation(options: Dict[str, Any]) -> int:
    """Samples per output frame: the raw-wave window_shift, and window_size
    too, that a cfg feeding this encoder needs so that its frames match the
    labels (ceil(160 n / 160) = n; a 400-sample window gives n + 2)."""
    return math.prod(read_pase_cfg(options)["strides"])


def mel_spaced_hz(n_filt: int, sample_rate: int) -> np.ndarray:
    """n_filt + 1 mel-spaced cut-offs from 30 Hz to sr/2 - 100 Hz, SincNet's
    init spacing: low_hz = [:-1], band_hz = diff."""
    return _to_hz(np.linspace(_to_mel(30.0), _to_mel(sample_rate / 2 - 100.0),
                              n_filt + 1))


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """x (N, C, L) padded as flax's "SAME" for a kernel k at stride s."""
    L = x.shape[-1]
    total = max((-(-L // s) - 1) * s + k - L, 0)
    return F.pad(x, (total // 2, total - total // 2))


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU on (N, C, L): x where x >= 0, else a x."""
    return torch.where(x >= 0, x, a[None, :, None] * x)


class PASE(nn.Module):
    """(T, B, 1) samples -> (ceil(T / decimation), B, emb_dim) frames."""

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        self.options, self.inp_dim = options, inp_dim
        cfg = read_pase_cfg(options)
        self.cfg = cfg
        n = cfg["sinc_out"]
        self.low_hz = nn.Parameter(torch.zeros(n, 1, device=device))
        self.band_hz = nn.Parameter(torch.zeros(n, 1, device=device))
        self.sinc_bn = batchnorm(n, device=device)
        self.sinc_act = nn.Parameter(torch.zeros(n, device=device))
        self.conv = nn.ModuleList()
        self.bn = nn.ModuleList()
        self.act = nn.ParameterList()
        prev = n
        for f, k, s in zip(cfg["fmaps"], cfg["kwidths"], cfg["strides"]):
            self.conv.append(nn.Conv1d(prev, f, k, stride=s, device=device))
            self.bn.append(batchnorm(f, device=device))
            self.act.append(nn.Parameter(torch.zeros(f, device=device)))
            prev = f
        self.emb = nn.Conv1d(prev, cfg["emb_dim"], 1, device=device)
        self.emb_bn = batchnorm(cfg["emb_dim"], device=device)
        self.reset_parameters(None)

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        return read_pase_cfg(options)["emb_dim"]

    @property
    def out_dim(self) -> int:
        return self.cfg["emb_dim"]

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """tpukaldi's init: the mel-spaced cut-offs, flax's lecun_normal
        conv kernels (a normal truncated at two deviations, variance 1 /
        fan_in) drawn from `generator`, zero biases, PReLU slopes 0.25,
        batchnorms at identity."""
        hz = mel_spaced_hz(self.cfg["sinc_out"], self.cfg["sample_rate"])
        with torch.no_grad():
            self.low_hz.copy_(torch.from_numpy(hz[:-1, None]))
            self.band_hz.copy_(torch.from_numpy(np.diff(hz)[:, None]))
            for a in (self.sinc_act, *self.act):
                a.fill_(0.25)
            for conv in (*self.conv, self.emb):
                fan_in = conv.weight.shape[1] * conv.weight.shape[2]
                # lecun_normal: std of the truncated draw sqrt(1 / fan_in)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(conv.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                conv.weight.copy_(w)
                conv.bias.zero_()
        for bn in (self.sinc_bn, *self.bn, self.emb_bn):
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, generator=None, lengths=None):
        refuse_bf16_input(x, "PASE")
        cfg = self.cfg
        h = x.permute(1, 2, 0)  # (B, 1, T)
        k = cfg["sinc_kwidth"]
        # float32 filters (float64 for a float64 module)
        dt = torch.float64 if self.low_hz.dtype == torch.float64 else torch.float32
        filt = sinc_filters_fast(self.low_hz.to(dt), self.band_hz.to(dt), k,
                                 cfg["sample_rate"], MIN_LOW_HZ, MIN_BAND_HZ)
        h = F.conv1d(same_pad(h, k, 1), filt[:, None, :].to(h.dtype)).abs()
        h = prelu(self.sinc_bn(h), self.sinc_act)
        for conv, bn, a in zip(self.conv, self.bn, self.act):
            h = conv(same_pad(h, conv.kernel_size[0], conv.stride[0]))
            h = prelu(bn(h), a)
        h = self.emb_bn(self.emb(h))
        return h.permute(2, 0, 1)  # (T', B, emb)
