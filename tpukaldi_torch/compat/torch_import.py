"""Reference pytorch-kaldi `.pkl` checkpoints, with their optimizer state,
to tpukaldi `.ckpt` files (counterpart of tpukaldi's
`compat/torch_import.py::import_optimizer_par`, `convert_checkpoint_file`
and `main`).

    python -m tpukaldi_torch.compat.torch_import <reference.pkl> <out.ckpt> <ArchClass>

The reference saves `{"model_par": state_dict, "optimizer_par":
optimizer.state_dict()}` per chunk (core.py:719).  The weights convert as
the port's weight map converts them (`compat/jax_params.py::to_jax_params`,
tpukaldi's `import_model_par`); each moment of the optimizer state follows
its weight by parameter name (the i-th index of the group is the i-th
parameter of `model_par`, buffers left out) and converts through the same
map, then goes into the optimizer state's layout in tpukaldi's checkpoint
(`train/optimizers.py::ArchOptimizer.state_tree`), the kind and
hyperparameters taken from the pkl's own `param_groups`.  So a resumed run
keeps its rmsprop, adam or momentum history, as the reference restores it
on every pretrain load (core.py:532).
"""

from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .jax_params import to_jax_params

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _param_names(model_par: Dict[str, Any]) -> list:
    """The parameters of `model_par`, in its (the module's) order."""
    return [k for k in model_par
            if not any(k.endswith(s) for s in _BUFFER_SUFFIXES)]


def _group_kind(group: Dict[str, Any]) -> Optional[str]:
    """The torch optimizer a param group belongs to, by its keys."""
    if "alpha" in group:
        return "rmsprop"
    if "betas" in group or "amsgrad" in group:
        return "adam"
    if "nesterov" in group or "dampening" in group:
        return "sgd"
    return None


def _optimizer_options(kind: str, g: Dict[str, Any]) -> Dict[str, Any]:
    """The cfg options (`opt_*`) that build the pkl's optimizer."""
    opts: Dict[str, Any] = {"opt_weight_decay": g.get("weight_decay", 0.0)}
    if kind == "rmsprop":
        opts.update(opt_alpha=g.get("alpha", 0.99), opt_eps=g.get("eps", 1e-8),
                    opt_centered=g.get("centered", False),
                    opt_momentum=g.get("momentum", 0.0))
    elif kind == "adam":
        opts.update(opt_betas=list(g.get("betas", (0.9, 0.999))),
                    opt_eps=g.get("eps", 1e-8),
                    opt_amsgrad=g.get("amsgrad", False))
    else:
        opts.update(opt_momentum=g.get("momentum", 0.0),
                    opt_nesterov=g.get("nesterov", False),
                    opt_dampening=g.get("dampening", 0.0))
    return opts


def import_optimizer_par(
    model_par: Dict[str, Any],
    optimizer_par: Dict[str, Any],
    class_name: str,
) -> Optional[Dict[str, Any]]:
    """A reference optimizer state_dict (`optimizer_par`) as the optimizer
    state tree of a tpukaldi checkpoint, for the `class_name` architecture
    whose weights `model_par` holds.  Returns
    None when there is nothing to import (momentum-0 sgd, whose torch state
    is empty, or a state no step has filled)."""
    from ..train.optimizers import ArchOptimizer

    state = optimizer_par.get("state") or {}
    groups = optimizer_par.get("param_groups") or []
    if not groups:
        return None
    g = groups[0]
    kind = _group_kind(g)
    if kind is None:
        return None
    names = _param_names(model_par)
    idxs = list(g.get("params", []))
    if len(idxs) != len(names):
        raise ValueError(
            f"optimizer group tracks {len(idxs)} params but model_par has "
            f"{len(names)} parameter tensors")
    # each index's state, under its parameter's name
    by_name = {names[pos]: state.get(idx, state.get(str(idx), {}))
               for pos, idx in enumerate(idxs)}
    # the chain's layout for this kind and these hyperparameters (a module
    # without parameters: the layout depends on the options alone)
    arch = SimpleNamespace(
        name=f"torch-import-{kind}", lr=[float(g.get("lr", 1e-3))],
        options={}, optimizer=SimpleNamespace(
            kind=kind, options=_optimizer_options(kind, g)))
    layout = ArchOptimizer(arch, nn.Module()).layout
    keys = {key for part in layout for key in part.values() if key != "step"}
    if not any(key in st for st in by_name.values() for key in keys):
        return None  # stateless (e.g. plain sgd): nothing to carry over

    buffers = {k: v for k, v in model_par.items()
               if any(k.endswith(s) for s in _BUFFER_SUFFIXES)}

    def moment_tree(key: str) -> Dict[str, Any]:
        """One moment arranged as the params tree (zeros where a parameter
        has none yet, as the optimizer's init)."""
        msd = dict(buffers)
        for name in names:
            st = by_name[name]
            msd[name] = st[key] if key in st else torch.zeros_like(
                torch.as_tensor(model_par[name]))
        return to_jax_params(msd, class_name)[0]

    count = next((int(_np(st["step"]).reshape(-1)[0])
                  for st in by_name.values() if "step" in st), 0)
    inner = {}
    for i, part in enumerate(layout):
        inner[str(i)] = {
            field: (np.asarray(count, np.int32) if key == "step"
                    else moment_tree(key))
            for field, key in part.items()}
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"lr": np.asarray(float(g.get("lr", 1e-3)),
                                             np.float32)},
            "hyperparams_states": {},
            "inner_state": inner}


def convert_checkpoint_file(
    pkl_path: str, out_ckpt: str, class_name: str
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a reference .pkl and write a tpukaldi .ckpt usable as
    `arch_pretrain_file` by either package.  Returns the (params,
    batch_stats) trees.  When the pkl carries `optimizer_par` its moments
    are converted too; where they cannot be mapped (an optimizer the
    port refuses, a layout mismatch) the checkpoint is written params-only
    with a warning on stderr, and a resumed run restarts the optimizer."""
    from ..train.checkpoint import write_checkpoint

    blob = torch.load(pkl_path, map_location="cpu", weights_only=True)
    sd = blob["model_par"] if "model_par" in blob else blob
    params, stats = to_jax_params(sd, class_name)
    opt_state = None
    if isinstance(blob, dict) and blob.get("optimizer_par"):
        try:
            opt_state = import_optimizer_par(sd, blob["optimizer_par"],
                                             class_name)
        except Exception as e:  # noqa: BLE001 — params still convert
            print(f"[torch_import] optimizer state not imported ({e}); "
                  "fine-tuning restarts the optimizer", file=sys.stderr)
    write_checkpoint(out_ckpt, params, opt_state=opt_state,
                     batch_stats=stats)
    return params, stats


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("usage: python -m tpukaldi_torch.compat.torch_import "
              "<reference.pkl> <out.ckpt> <ArchClass>", file=sys.stderr)
        return 2
    convert_checkpoint_file(argv[0], argv[1], argv[2])
    print(f"wrote {argv[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
