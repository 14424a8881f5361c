"""Weights between tpukaldi's parameter trees and the port's state_dicts.

`from_jax_params` maps numpy trees in tpukaldi naming (`wh{i}`, `uz{i}`,
`bn_ff{i}` scale/bias + mean/var, `wx{i}` kernel/bias, the QLSTM's
`wfx{i}` r/i/j/k/bias and `ufh{i}`, the conv stacks' `conv{i}`/`conv{i}_b`,
`low_hz`/`band_hz`, `ln{i}`, `ln_inp`, ...) onto the port's
reference-layout state_dict.  `to_jax_params(state_dict, class_name)` is
the inverse, the port's copy of the MLP, CNN/SincNet, QLSTM and gate-table
branches of tpukaldi's tested converter
`compat/torch_import.py::import_model_par`, in numpy only, with branches of
its own for the classes that converter does not take: the `*_cudnn`
family (tpukaldi's per-layer `w_ih{l}`/`w_hh{l}` (K, in, G*H) and
`b_ih{l}`/`b_hh{l}` (K, G*H) against torch's per-direction
`weight_ih_l{l}[_reverse]` (G*H, in) ...), SRU (the same names) and
fusionRNN (`fuse_wz0`/`fuse_wh0` w/b, `w{i}`/`b{i}`, `bn_wz{i}`,
`bn_wh{i}`, `u{i}`) and PASE (`low_hz`, `band_hz`, `sinc_bn`, `sinc_act`,
`conv{i}` with flax's NWC kernel (k, in, out) against torch's (out, in, k),
`bn{i}`, `act{i}`, `emb`, `emb_bn`).  logMelFb and channel_averaging have
no parameters: empty trees both ways.

`convert_pase_checkpoint` and `convert_pase_checkpoint_file` map a pase
package state dict onto PASE's tree, as tpukaldi's
`compat/torch_import.py:217-329` do.

`moments_to_jax` / `moments_from_jax` carry a per-parameter tensor set
(an optimizer moment such as rmsprop's `square_avg`) through the same two
maps, so optimizer state lands in the tree layout of tpukaldi's optax state
(e.g. `inner_state/0/nu`), which mirrors its parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# (tpukaldi gate letter, torch ff attr, torch recurrent attr), in tpukaldi's
# FF_GATES order, as tpukaldi's `torch_import._GATE_TABLES` has them.  The
# GRU's `uh{i}` is one of tpukaldi's extra params, outside its fused Uzr; the
# ("h", "wh", "uh") row maps it all the same.  The QLSTM's gates are the
# LSTM's.
_GATES = {
    "liGRU": (("h", "wh", "uh"), ("z", "wz", "uz")),
    "minimalGRU": (("h", "wh", "uh"), ("z", "wz", "uz")),
    "GRU": (("h", "wh", "uh"), ("z", "wz", "uz"), ("r", "wr", "ur")),
    "RNN": (("h", "wh", "uh"),),
    "LSTM": (("f", "wfx", "ufh"), ("i", "wix", "uih"), ("o", "wox", "uoh"),
             ("c", "wcx", "uch")),
}
# the four real components of a quaternion weight, in their stacking order
_QUAT = ("r", "i", "j", "k")
# the raw-waveform conv stacks
_CONV = ("CNN", "SincNet")
# the torch RNN wrappers: class -> the ModuleList holding the torch module
_CUDNN = {"LSTM_cudnn": "lstm", "GRU_cudnn": "gru", "RNN_cudnn": "rnn"}
_DIRECTIONS = ("", "_reverse")
_SRU = ("w", "vf", "vr", "bf", "br")
_FUSION = ("fusionRNN", "fusionRNN_jit")
# the front ends without parameters
_PARAMLESS = ("logMelFb", "channel_averaging")
_PORTED = ("MLP", "QLSTM", "SRU", "PASE", *_CONV, *_GATES, *_CUDNN, *_FUSION,
           *_PARAMLESS)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _bn(sd, key, scale, bias, mean, var) -> None:
    sd[f"{key}.weight"] = _t(scale)
    sd[f"{key}.bias"] = _t(bias)
    sd[f"{key}.running_mean"] = _t(mean)
    sd[f"{key}.running_var"] = _t(var)
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def from_jax_params(class_name: str, params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """tpukaldi (params, batch_stats) of one architecture -> port state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    stats = batch_stats or {}
    if class_name == "MLP":
        i = 0
        while f"wx{i}" in params:
            dense = params[f"wx{i}"]
            sd[f"wx.{i}.weight"] = _t(np.asarray(dense["kernel"]).T)
            if "bias" in dense:
                sd[f"wx.{i}.bias"] = _t(dense["bias"])
            if f"ln{i}" in params:
                sd[f"ln.{i}.gamma"] = _t(params[f"ln{i}"]["gamma"])
                sd[f"ln.{i}.beta"] = _t(params[f"ln{i}"]["beta"])
            if f"bn{i}" in params:
                _bn(sd, f"bn.{i}", params[f"bn{i}"]["scale"],
                    params[f"bn{i}"]["bias"], stats[f"bn{i}"]["mean"],
                    stats[f"bn{i}"]["var"])
            i += 1
        if "ln_inp" in params:
            sd["ln0.gamma"] = _t(params["ln_inp"]["gamma"])
            sd["ln0.beta"] = _t(params["ln_inp"]["beta"])
    elif class_name in _GATES:
        gates = _GATES[class_name]
        i = 0
        while f"w{gates[0][0]}{i}" in params:
            for k, (g, w_attr, u_attr) in enumerate(gates):
                sd[f"{w_attr}.{i}.weight"] = _t(np.asarray(params[f"w{g}{i}"]).T)
                if f"b{g}{i}" in params:
                    sd[f"{w_attr}.{i}.bias"] = _t(params[f"b{g}{i}"])
                sd[f"{u_attr}.{i}.weight"] = _t(np.asarray(params[f"u{g}{i}"]).T)
                if f"bn_ff{i}" in params:
                    # the fused feature batchnorm splits back into per-gate
                    # BatchNorm1d blocks in FF_GATES order
                    H = np.asarray(params[f"u{g}{i}"]).shape[0]
                    part = slice(k * H, (k + 1) * H)
                    p, s = params[f"bn_ff{i}"], stats[f"bn_ff{i}"]
                    _bn(sd, f"bn_{w_attr}.{i}", np.asarray(p["scale"])[part],
                        np.asarray(p["bias"])[part], np.asarray(s["mean"])[part],
                        np.asarray(s["var"])[part])
            if f"ln{i}_gamma" in params:
                sd[f"ln.{i}.gamma"] = _t(params[f"ln{i}_gamma"])
                sd[f"ln.{i}.beta"] = _t(params[f"ln{i}_beta"])
            i += 1
        if "ln_inp_gamma" in params:
            sd["ln0.gamma"] = _t(params["ln_inp_gamma"])
            sd["ln0.beta"] = _t(params["ln_inp_beta"])
    elif class_name == "QLSTM":
        # quaternion weights keep their (in/4, out/4) component layout on
        # both sides: nothing transposes
        i = 0
        while f"wfx{i}" in params:
            for g, w_attr, u_attr in _GATES["LSTM"]:
                dense = params[f"w{g}x{i}"]
                for c in _QUAT:
                    sd[f"{w_attr}.{i}.{c}_weight"] = _t(dense[c])
                if "bias" in dense:
                    sd[f"{w_attr}.{i}.bias"] = _t(dense["bias"])
                rec = np.asarray(params[f"u{g}h{i}"])
                for k, c in enumerate(_QUAT):
                    sd[f"{u_attr}.{i}.{c}_weight"] = _t(rec[k])
            i += 1
    elif class_name in _CONV:
        # conv weights keep torch's (out, in, K) layout on both sides
        i = 0
        while True:
            if i == 0 and "low_hz" in params:
                sd["conv.0.low_hz_"] = _t(params["low_hz"])
                sd["conv.0.band_hz_"] = _t(params["band_hz"])
            elif f"conv{i}" in params:
                sd[f"conv.{i}.weight"] = _t(params[f"conv{i}"])
                if f"conv{i}_b" in params:
                    sd[f"conv.{i}.bias"] = _t(params[f"conv{i}_b"])
            else:
                break
            if f"ln{i}" in params:
                sd[f"ln.{i}.gamma"] = _t(params[f"ln{i}"]["gamma"])
                sd[f"ln.{i}.beta"] = _t(params[f"ln{i}"]["beta"])
            if f"bn{i}" in params:
                _bn(sd, f"bn.{i}", params[f"bn{i}"]["scale"],
                    params[f"bn{i}"]["bias"], stats[f"bn{i}"]["mean"],
                    stats[f"bn{i}"]["var"])
            i += 1
        if "ln_inp" in params:
            sd["ln0.gamma"] = _t(params["ln_inp"]["gamma"])
            sd["ln0.beta"] = _t(params["ln_inp"]["beta"])
    elif class_name in _CUDNN:
        rnn = f"{_CUDNN[class_name]}.0"
        i = 0
        while f"w_ih{i}" in params:
            for k, suffix in enumerate(_DIRECTIONS[:len(params[f"w_ih{i}"])]):
                for kind in ("ih", "hh"):
                    sd[f"{rnn}.weight_{kind}_l{i}{suffix}"] = _t(
                        np.asarray(params[f"w_{kind}{i}"])[k].T)
                    if f"b_{kind}{i}" in params:
                        sd[f"{rnn}.bias_{kind}_l{i}{suffix}"] = _t(
                            np.asarray(params[f"b_{kind}{i}"])[k])
            i += 1
    elif class_name == "SRU":
        i = 0
        while f"w{i}" in params:
            for v in _SRU:
                sd[f"{v}{i}"] = _t(params[f"{v}{i}"])
            if f"ln{i}" in params:
                sd[f"ln{i}.gamma"] = _t(params[f"ln{i}"]["gamma"])
                sd[f"ln{i}.beta"] = _t(params[f"ln{i}"]["beta"])
            i += 1
    elif class_name in _FUSION:
        for g in ("wz", "wh"):
            if f"fuse_{g}0" in params:
                sd[f"fuse_{g}.weight"] = _t(
                    np.asarray(params[f"fuse_{g}0"]["w"]).T)
                sd[f"fuse_{g}.bias"] = _t(params[f"fuse_{g}0"]["b"])
        i = 0
        while f"u{i}" in params:
            if f"w{i}" in params:
                sd[f"w.{i}.weight"] = _t(np.asarray(params[f"w{i}"]).T)
                sd[f"w.{i}.bias"] = _t(params[f"b{i}"])
            for g in ("wz", "wh"):
                key = f"bn_{g}{i}"
                _bn(sd, f"bn_{g}.{i}", params[key]["scale"],
                    params[key]["bias"], stats[key]["mean"], stats[key]["var"])
            sd[f"u.{i}"] = _t(params[f"u{i}"])
            i += 1
    elif class_name == "PASE":
        sd["low_hz"] = _t(params["low_hz"])
        sd["band_hz"] = _t(params["band_hz"])
        for kind, key, port in _pase_layers(params):
            if kind == "conv":
                sd[f"{port}.weight"] = _t(
                    np.asarray(params[key]["kernel"]).transpose(2, 1, 0))
                sd[f"{port}.bias"] = _t(params[key]["bias"])
            elif kind == "bn":
                _bn(sd, port, params[key]["scale"], params[key]["bias"],
                    stats[key]["mean"], stats[key]["var"])
            else:
                sd[port] = _t(params[key])
    elif class_name not in _PARAMLESS:
        raise NotImplementedError(
            f"weight mapping for {class_name!r} is still to be ported "
            f"(ported: {', '.join(_PORTED)})")
    if "bn_inp" in params:
        _bn(sd, "bn0", params["bn_inp"]["scale"], params["bn_inp"]["bias"],
            stats["bn_inp"]["mean"], stats["bn_inp"]["var"])
    return sd


def _pase_layers(tree: Dict[str, Any]):
    """(kind: conv, bn or act; tpukaldi name; port state_dict prefix) of
    PASE's layers after the cut-offs, in order, for the blocks `tree` has
    (tpukaldi's `conv{i}` or the port's `conv.{i}.weight` keys)."""
    out = [("bn", "sinc_bn", "sinc_bn"), ("act", "sinc_act", "sinc_act")]
    i = 0
    while f"conv{i}" in tree or f"conv.{i}.weight" in tree:
        out += [("conv", f"conv{i}", f"conv.{i}"), ("bn", f"bn{i}", f"bn.{i}"),
                ("act", f"act{i}", f"act.{i}")]
        i += 1
    return out + [("conv", "emb", "emb"), ("bn", "emb_bn", "emb_bn")]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _n_layers(sd: Dict[str, Any], attr: str) -> int:
    n = 0
    while f"{attr}.{n}.weight" in sd:
        n += 1
    return n


def _bn_tree(sd: Dict[str, Any], key: str) -> Optional[Dict[str, np.ndarray]]:
    if f"{key}.weight" not in sd:
        return None
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"]),
            "mean": _np(sd[f"{key}.running_mean"]),
            "var": _np(sd[f"{key}.running_var"])}


def _put_bn(params, stats, name, bn) -> None:
    if bn:
        params[name] = {"scale": bn["scale"], "bias": bn["bias"]}
        stats[name] = {"mean": bn["mean"], "var": bn["var"]}


def to_jax_params(state_dict: Dict[str, Any], class_name: str
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A port (reference-layout) state_dict of one architecture -> tpukaldi
    (params, batch_stats) numpy trees: per-gate batchnorms joined into one
    feature batchnorm in FF_GATES order, Linear weights transposed."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if class_name == "MLP":
        for i in range(_n_layers(sd, "wx")):
            dense = {"kernel": _np(sd[f"wx.{i}.weight"]).T}
            if f"wx.{i}.bias" in sd:
                dense["bias"] = _np(sd[f"wx.{i}.bias"])
            params[f"wx{i}"] = dense
            if f"ln.{i}.gamma" in sd:
                params[f"ln{i}"] = {"gamma": _np(sd[f"ln.{i}.gamma"]),
                                    "beta": _np(sd[f"ln.{i}.beta"])}
            _put_bn(params, stats, f"bn{i}", _bn_tree(sd, f"bn.{i}"))
        if "ln0.gamma" in sd:
            params["ln_inp"] = {"gamma": _np(sd["ln0.gamma"]),
                                "beta": _np(sd["ln0.beta"])}
        _put_bn(params, stats, "bn_inp", _bn_tree(sd, "bn0"))
        return params, stats

    if class_name in _CONV:
        if "ln0.gamma" in sd:
            params["ln_inp"] = {"gamma": _np(sd["ln0.gamma"]),
                                "beta": _np(sd["ln0.beta"])}
        _put_bn(params, stats, "bn_inp", _bn_tree(sd, "bn0"))
        i = 0
        while True:
            if f"conv.{i}.low_hz_" in sd:
                params["low_hz"] = _np(sd[f"conv.{i}.low_hz_"])
                params["band_hz"] = _np(sd[f"conv.{i}.band_hz_"])
            elif f"conv.{i}.weight" in sd:
                params[f"conv{i}"] = _np(sd[f"conv.{i}.weight"])
                if f"conv.{i}.bias" in sd:
                    params[f"conv{i}_b"] = _np(sd[f"conv.{i}.bias"])
            else:
                break
            if f"ln.{i}.gamma" in sd:
                params[f"ln{i}"] = {"gamma": _np(sd[f"ln.{i}.gamma"]),
                                    "beta": _np(sd[f"ln.{i}.beta"])}
            _put_bn(params, stats, f"bn{i}", _bn_tree(sd, f"bn.{i}"))
            i += 1
        return params, stats

    if class_name in _PARAMLESS:
        return params, stats

    if class_name == "PASE":
        params["low_hz"] = _np(sd["low_hz"])
        params["band_hz"] = _np(sd["band_hz"])
        for kind, key, port in _pase_layers(sd):
            if kind == "conv":
                params[key] = {
                    "kernel": _np(sd[f"{port}.weight"]).transpose(2, 1, 0),
                    "bias": _np(sd[f"{port}.bias"])}
            elif kind == "bn":
                _put_bn(params, stats, key, _bn_tree(sd, port))
            else:
                params[key] = _np(sd[port])
        return params, stats

    if class_name == "QLSTM":
        i = 0
        while f"wfx.{i}.r_weight" in sd:
            for g, w_attr, u_attr in _GATES["LSTM"]:
                quad = {c: _np(sd[f"{w_attr}.{i}.{c}_weight"]) for c in _QUAT}
                if f"{w_attr}.{i}.bias" in sd:
                    quad["bias"] = _np(sd[f"{w_attr}.{i}.bias"])
                params[f"w{g}x{i}"] = quad
                params[f"u{g}h{i}"] = np.stack(
                    [_np(sd[f"{u_attr}.{i}.{c}_weight"]) for c in _QUAT])
            i += 1
        return params, stats

    if class_name in _CUDNN:
        rnn = f"{_CUDNN[class_name]}.0"
        i = 0
        while f"{rnn}.weight_ih_l{i}" in sd:
            dirs = [d for d in _DIRECTIONS
                    if f"{rnn}.weight_ih_l{i}{d}" in sd]
            for kind in ("ih", "hh"):
                params[f"w_{kind}{i}"] = np.stack(
                    [_np(sd[f"{rnn}.weight_{kind}_l{i}{d}"]).T for d in dirs])
                if f"{rnn}.bias_{kind}_l{i}" in sd:
                    params[f"b_{kind}{i}"] = np.stack(
                        [_np(sd[f"{rnn}.bias_{kind}_l{i}{d}"]) for d in dirs])
            i += 1
        return params, stats

    if class_name == "SRU":
        i = 0
        while f"w{i}" in sd:
            for v in _SRU:
                params[f"{v}{i}"] = _np(sd[f"{v}{i}"])
            if f"ln{i}.gamma" in sd:
                params[f"ln{i}"] = {"gamma": _np(sd[f"ln{i}.gamma"]),
                                    "beta": _np(sd[f"ln{i}.beta"])}
            i += 1
        return params, stats

    if class_name in _FUSION:
        for g in ("wz", "wh"):
            if f"fuse_{g}.weight" in sd:
                params[f"fuse_{g}0"] = {"w": _np(sd[f"fuse_{g}.weight"]).T,
                                        "b": _np(sd[f"fuse_{g}.bias"])}
        i = 0
        while f"u.{i}" in sd:
            if f"w.{i}.weight" in sd:
                params[f"w{i}"] = _np(sd[f"w.{i}.weight"]).T
                params[f"b{i}"] = _np(sd[f"w.{i}.bias"])
            for g in ("wz", "wh"):
                _put_bn(params, stats, f"bn_{g}{i}",
                        _bn_tree(sd, f"bn_{g}.{i}"))
            params[f"u{i}"] = _np(sd[f"u.{i}"])
            i += 1
        return params, stats

    if class_name not in _GATES:
        raise NotImplementedError(
            f"weight mapping for {class_name!r} is still to be ported "
            f"(ported: {', '.join(_PORTED)})")
    gates = _GATES[class_name]
    for i in range(_n_layers(sd, gates[0][1])):
        bn_parts = []
        for g, w_attr, u_attr in gates:
            params[f"w{g}{i}"] = _np(sd[f"{w_attr}.{i}.weight"]).T
            if f"{w_attr}.{i}.bias" in sd:
                params[f"b{g}{i}"] = _np(sd[f"{w_attr}.{i}.bias"])
            params[f"u{g}{i}"] = _np(sd[f"{u_attr}.{i}.weight"]).T
            bn = _bn_tree(sd, f"bn_{w_attr}.{i}")
            if bn:
                bn_parts.append(bn)
        if bn_parts:
            _put_bn(params, stats, f"bn_ff{i}", {
                k: np.concatenate([b[k] for b in bn_parts])
                for k in ("scale", "bias", "mean", "var")})
        if f"ln.{i}.gamma" in sd:
            params[f"ln{i}_gamma"] = _np(sd[f"ln.{i}.gamma"])
            params[f"ln{i}_beta"] = _np(sd[f"ln.{i}.beta"])
    if "ln0.gamma" in sd:
        params["ln_inp_gamma"] = _np(sd["ln0.gamma"])
        params["ln_inp_beta"] = _np(sd["ln0.beta"])
    _put_bn(params, stats, "bn_inp", _bn_tree(sd, "bn0"))
    return params, stats


def moments_to_jax(module: torch.nn.Module, moments: Dict[str, Any],
                   state_dict: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """{parameter name: tensor or array shaped like it} -> a numpy tree in
    tpukaldi's parameter naming (per-gate batchnorm halves joined, Linear
    weights transposed).  The map needs the module's buffers too: from
    `state_dict` where given (a copy taken earlier), else from the module."""
    sd = dict(module.state_dict() if state_dict is None else state_dict)
    sd.update(moments)
    params, _ = to_jax_params(sd, type(module).__name__)
    return params


def moments_from_jax(module: torch.nn.Module,
                     tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of `moments_to_jax`: {parameter name: tensor}."""
    # from_jax_params also maps batchnorm statistics; any array of the
    # right shape serves for them, and they are dropped below
    stats = {k: {"mean": v["scale"], "var": v["scale"]}
             for k, v in tree.items() if isinstance(v, dict) and "scale" in v}
    sd = from_jax_params(type(module).__name__, tree, stats)
    return {name: sd[name] for name, _ in module.named_parameters()}


def convert_pase_checkpoint(
    state_dict: Dict[str, Any], options: Dict[str, Any]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A pase package front-end state dict -> PASE's (params, batch_stats)
    numpy trees in tpukaldi's naming (tpukaldi's
    `compat/torch_import.py::convert_pase_checkpoint`).  Module prefixes
    vary across pase versions, so the modules are read in order of
    appearance and told apart by their contents: `low_hz_`/`band_hz_` the
    sinc layer, a prefix with `running_mean` a BatchNorm, a 3-D `weight` a
    Conv1d ((out, in, k) -> NWC (k, in, out)), a lone 1-D `weight` a PReLU
    slope (a scalar one broadcast per channel); anything else (workers,
    decoders) is skipped.  A conv whose shape does not fit the pase_cfg,
    or a checkpoint that runs out of a module, raises."""
    from ..models.pase import read_pase_cfg

    cfg = read_pase_cfg(options)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if "num_batches_tracked" not in leaf:
            groups.setdefault(prefix, {})[leaf] = _np(val)
    seq = []  # (kind, group) in order of appearance
    for g in groups.values():
        if "low_hz_" in g or "band_hz_" in g:
            seq.append(("sinc", g))
        elif "running_mean" in g:
            seq.append(("bn", g))
        elif "weight" in g and g["weight"].ndim == 3:
            seq.append(("conv", g))
        elif "weight" in g and g["weight"].ndim <= 1 and len(g) == 1:
            seq.append(("prelu", g))

    def take(kind, where):
        while seq:
            k, g = seq.pop(0)
            if k == kind:
                return g
        raise ValueError(
            f"pase checkpoint exhausted looking for a {kind!r} for {where!r}")

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    sinc = take("sinc", "sinc front-end")
    params["low_hz"] = sinc["low_hz_"].reshape(-1, 1)
    params["band_hz"] = sinc["band_hz_"].reshape(-1, 1)

    def put_bn(name):
        g = take("bn", name)
        params[name] = {"scale": g["weight"], "bias": g["bias"]}
        stats[name] = {"mean": g["running_mean"], "var": g["running_var"]}

    def put_prelu(name, n_chan):
        w = take("prelu", name)["weight"].reshape(-1)
        if w.size == 1:  # torch's scalar PReLU broadcasts per channel
            w = np.broadcast_to(w, (n_chan,)).copy()
        params[name] = w

    def put_conv(name, g):
        conv = {"kernel": g["weight"].transpose(2, 1, 0)}
        if "bias" in g:
            conv["bias"] = g["bias"]
        params[name] = conv

    put_bn("sinc_bn")
    put_prelu("sinc_act", cfg["sinc_out"])
    for i, (f, k) in enumerate(zip(cfg["fmaps"], cfg["kwidths"])):
        g = take("conv", f"conv{i}")
        if g["weight"].shape[0] != f or g["weight"].shape[2] != k:
            raise ValueError(
                f"conv{i}: checkpoint shape {g['weight'].shape} does not "
                f"match pase_cfg (fmaps={f}, kwidth={k})")
        put_conv(f"conv{i}", g)
        put_bn(f"bn{i}")
        put_prelu(f"act{i}", f)
    put_conv("emb", take("conv", "emb"))
    put_bn("emb_bn")
    return params, stats


def convert_pase_checkpoint_file(
    ckpt_path: str, cfg_path: str, out_ckpt: str
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """`torch.load` a pase checkpoint (a state dict, a `{"model": ...}`
    blob or a module) and write PASE's weights as a `.ckpt` in the format
    both packages read, usable as `arch_pretrain_file`."""
    from ..train.checkpoint import write_checkpoint

    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params, stats = convert_pase_checkpoint(sd, {"pase_cfg": cfg_path})
    write_checkpoint(out_ckpt, params, None, stats)
    return params, stats
