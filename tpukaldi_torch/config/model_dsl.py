"""The [model] composition DSL: parse + static checking.

Grammar (reference proto/model.proto): a straight-line SSA program of
  out=compute(architecture, input)
  out=concatenate(a, b) | mult | sum | avg | mse (input, input)
  out=mult_constant(a, float) | sum_constant(a, float)
  loss=cost_nll(out, label) | err=cost_err(out, label)
`loss_final` and `err_final` are mandatory outputs (utils.py:1533-1629
static check).  Here the program parses into ModelStatement tuples which
graph/compiler.py later compiles to one jitted pure function — the
reference instead re-interprets the strings every minibatch
(utils.py:2296-2419).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

from .schema import ConfigError

# op -> (arg1 kind, arg2 kind); kinds: arch, input, label, const
OPS = {
    "compute": ("arch", "input"),
    "concatenate": ("input", "input"),
    "cost_nll": ("input", "label"),
    "cost_err": ("input", "label"),
    "mult": ("input", "input"),
    "mult_constant": ("input", "const"),
    "sum": ("input", "input"),
    "sum_constant": ("input", "const"),
    "avg": ("input", "input"),
    "mse": ("input", "input"),
}

_STMT_RE = re.compile(r"^\s*([\w.]+)\s*=\s*(\w+)\(([^,()]+),([^,()]+)\)\s*$")


@dataclass(frozen=True)
class ModelStatement:
    out: str
    op: str
    arg1: str
    arg2: str

    def __str__(self):
        return f"{self.out}={self.op}({self.arg1},{self.arg2})"


def parse_model(model_field: str) -> List[ModelStatement]:
    stmts = []
    for line in model_field.split("\n"):
        line = line.strip()
        if not line:
            continue
        m = _STMT_RE.match(line)
        if not m:
            raise ConfigError(
                f"model line {line!r} does not match 'out=op(arg1,arg2)'"
            )
        out, op, a1, a2 = (g.strip() for g in m.groups())
        if op not in OPS:
            raise ConfigError(f"model line {line!r}: unknown operation {op!r} "
                              f"(valid: {sorted(OPS)})")
        stmts.append(ModelStatement(out, op, a1, a2))
    if not stmts:
        raise ConfigError("empty [model] section")
    return stmts


def validate_model(
    stmts: Sequence[ModelStatement],
    fea_names: Sequence[str],
    lab_names: Sequence[str],
    arch_names: Sequence[str],
) -> None:
    """Static SSA check: every operand defined before use, arch/label refs
    resolve, loss_final and err_final are produced."""
    defined = set(fea_names)
    produced = set()
    for s in stmts:
        kinds = OPS[s.op]
        for arg, kind in ((s.arg1, kinds[0]), (s.arg2, kinds[1])):
            if kind == "arch":
                if arg not in arch_names:
                    raise ConfigError(
                        f"{s}: architecture {arg!r} not defined "
                        f"(have {sorted(arch_names)})"
                    )
            elif kind == "label":
                if arg not in lab_names:
                    raise ConfigError(
                        f"{s}: label {arg!r} not defined (have {sorted(lab_names)})"
                    )
            elif kind == "const":
                try:
                    float(arg)
                except ValueError:
                    raise ConfigError(f"{s}: constant {arg!r} is not a number")
            else:  # input
                if arg not in defined:
                    raise ConfigError(
                        f"{s}: input {arg!r} used before definition "
                        f"(defined so far: {sorted(defined)})"
                    )
        if s.out in produced:
            raise ConfigError(f"{s}: output {s.out!r} assigned twice")
        produced.add(s.out)
        defined.add(s.out)
    for required in ("loss_final", "err_final"):
        if required not in produced:
            raise ConfigError(f"[model] must produce {required!r}")


def used_names(stmts: Sequence[ModelStatement], candidates: Sequence[str], kind: str):
    """Which of `candidates` (fea/lab/arch names) the program references."""
    used = []
    for s in stmts:
        kinds = OPS[s.op]
        for arg, k in ((s.arg1, kinds[0]), (s.arg2, kinds[1])):
            want = kind == k or (kind == "input" and k == "input")
            if want and arg in candidates and arg not in used:
                used.append(arg)
    return used
