"""Per-epoch scheduler micro-syntax: ``v1*N|v2*M`` (reference README "flexible
scheduler"; utils.py:2656-2701 `expand_str_ep`).

`expand_schedule("0.08*10|0.04*5", 15)` -> 15 values; a single bare value
replicates across all epochs; the expanded length must equal n_epochs.
Used for learning rates, batch sizes, max sequence lengths, and per-layer
dropout factors (each comma-separated layer entry may carry its own
schedule).
"""

from __future__ import annotations

from typing import List

from .schema import ConfigError


def expand_schedule(compact: str, n_epochs: int, cast=str) -> List:
    out: List[str] = []
    groups = compact.split("|")
    for group in groups:
        parts = group.split("*")
        value = parts[0]
        try:
            cast(value)
        except ValueError:
            raise ConfigError(f"schedule {compact!r}: {value!r} is not a valid value")
        if len(parts) == 2:
            try:
                repeat = int(parts[1])
            except ValueError:
                raise ConfigError(f"schedule {compact!r}: repeat count {parts[1]!r} is not an int")
            out.extend([value] * repeat)
        elif len(parts) == 1:
            out.append(value)
        else:
            raise ConfigError(f"schedule {compact!r}: too many '*' in {group!r}")
    if len(groups) == 1 and "*" not in groups[0]:
        out.extend([groups[0]] * (n_epochs - 1))
    if len(out) != n_epochs:
        raise ConfigError(
            f"schedule {compact!r} expands to {len(out)} values but there are "
            f"{n_epochs} epochs"
        )
    return [cast(v) for v in out]


def expand_layerwise_schedule(compact: str, n_epochs: int) -> List[List[float]]:
    """Per-layer dropout schedules: comma separates layers, each layer entry
    is its own `v*N|v*M` schedule.  Returns [layer][epoch] floats."""
    layers = compact.split(",")
    table = [expand_schedule(lay, n_epochs, cast=float) for lay in layers]
    for sched in table:
        for v in sched:
            if not (0.0 <= v <= 1.0):
                raise ConfigError(f"dropout rate {v} out of [0,1] in {compact!r}")
    return table


def layerwise_value_at(table: List[List[float]], epoch: int) -> str:
    """Materialize the comma-joined per-layer value string for one epoch."""
    return ",".join(str(sched[epoch]) for sched in table)
