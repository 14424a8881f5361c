"""Weights between tpukaldi's parameter trees and the port's state_dicts.

`from_jax_params` maps numpy trees in tpukaldi naming (`wh{i}`, `uz{i}`,
`bn_ff{i}` scale/bias + mean/var, `wx{i}` kernel/bias, ...) onto the port's
reference-layout state_dict.  The inverse is tpukaldi's own tested
converter, `tpukaldi.compat.torch_import.import_model_par` (importable
without JAX), re-exported here as `to_jax_params(state_dict, class_name)`.

`moments_to_jax` / `moments_from_jax` carry a per-parameter tensor set
(an optimizer moment such as rmsprop's `square_avg`) through the same two
maps, so optimizer state lands in the tree layout of tpukaldi's optax state
(e.g. `inner_state/0/nu`), which mirrors its parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpukaldi.compat.torch_import import import_model_par as to_jax_params  # noqa: F401

# (tpukaldi gate letter, torch ff attr, torch recurrent attr), in tpukaldi's
# FF_GATES order, as tpukaldi.compat.torch_import._GATE_TABLES has them.  The
# GRU's `uh{i}` is one of tpukaldi's extra params, outside its fused Uzr; the
# ("h", "wh", "uh") row maps it all the same.
_GATES = {
    "liGRU": (("h", "wh", "uh"), ("z", "wz", "uz")),
    "GRU": (("h", "wh", "uh"), ("z", "wz", "uz"), ("r", "wr", "ur")),
    "LSTM": (("f", "wfx", "ufh"), ("i", "wix", "uih"), ("o", "wox", "uoh"),
             ("c", "wcx", "uch")),
}


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
    else:
        raise NotImplementedError(
            f"weight mapping for {class_name!r} is still to be ported "
            f"(ported: MLP, {', '.join(_GATES)})")
    if "bn_inp" in params:
        _bn(sd, "bn0", params["bn_inp"]["scale"], params["bn_inp"]["bias"],
            stats["bn_inp"]["mean"], stats["bn_inp"]["var"])
    return sd


def moments_to_jax(module: torch.nn.Module,
                   moments: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{parameter name: tensor shaped like it} -> a numpy tree in tpukaldi's
    parameter naming (per-gate batchnorm halves joined, Linear weights
    transposed)."""
    sd = dict(module.state_dict())  # buffers, which the map needs too
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
