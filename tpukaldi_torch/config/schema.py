"""Typed field validation for the INI+proto config surface.

Implements the same type language the reference's proto files use
(utils.py:166-340 `check_field`): `str`, `path`, `bool`, `bool_list`,
`int(l,u)` / `float(l,u)` with `-inf`/`inf` bounds, `int_list(l,u)`,
`float_list(l,u)`, `str_list`/`list_str`, bare `int`/`float`, and
`{enum,a,b}` sets.  Errors raise ConfigError instead of sys.exit so the
framework is embeddable; the CLI converts them to exit codes.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable

TRUE_SET = {"True", "true", "1"}
FALSE_SET = {"False", "false", "0"}
BOOL_SET = TRUE_SET | FALSE_SET


class ConfigError(ValueError):
    """Invalid configuration value or structure."""


def to_bool(value: str) -> bool:
    if value in TRUE_SET:
        return True
    if value in FALSE_SET:
        return False
    raise ConfigError(f"not a boolean: {value!r}")


def _parse_bounds(spec: str, prefix: str):
    body = spec[len(prefix) + 1 : -1]
    lo_s, hi_s = body.split(",")
    lo = float("-inf") if lo_s == "-inf" else float(lo_s)
    hi = float("inf") if hi_s == "inf" else float(hi_s)
    return lo, hi


def _check_range(value: float, lo: float, hi: float, field: str, raw: str) -> None:
    if value < lo:
        raise ConfigError(f"field {field!r}: {raw!r} is below the minimum {lo}")
    if value > hi:
        raise ConfigError(f"field {field!r}: {raw!r} is above the maximum {hi}")


def make_checker(spec: str) -> Callable[[str, str], Any]:
    """Compile a type-spec string into a `checker(value, field) -> parsed`."""
    spec = spec.strip()

    if spec.startswith("{") and spec.endswith("}"):
        choices = spec[1:-1].split(",")

        def check_enum(value, field):
            if value not in choices:
                raise ConfigError(f"field {field!r} must be one of {choices}, got {value!r}")
            return value

        return check_enum

    if spec.startswith("int_list("):
        lo, hi = _parse_bounds(spec, "int_list")

        def check_int_list(value, field):
            try:
                parsed = [int(v) for v in value.split(",")]
            except ValueError:
                raise ConfigError(f"field {field!r} must be a comma list of ints, got {value!r}")
            for v in parsed:
                _check_range(v, lo, hi, field, value)
            return parsed

        return check_int_list

    if spec.startswith("float_list("):
        lo, hi = _parse_bounds(spec, "float_list")

        def check_float_list(value, field):
            try:
                parsed = [float(v) for v in value.split(",")]
            except ValueError:
                raise ConfigError(f"field {field!r} must be a comma list of floats, got {value!r}")
            for v in parsed:
                _check_range(v, lo, hi, field, value)
            return parsed

        return check_float_list

    if spec.startswith("int(") or spec == "int":
        lo, hi = _parse_bounds(spec, "int") if "(" in spec else (float("-inf"), float("inf"))

        def check_int(value, field):
            try:
                v = int(value)
            except ValueError:
                raise ConfigError(f"field {field!r} must be an int, got {value!r}")
            _check_range(v, lo, hi, field, value)
            return v

        return check_int

    if spec.startswith("float(") or spec == "float":
        lo, hi = _parse_bounds(spec, "float") if "(" in spec else (float("-inf"), float("inf"))

        def check_float(value, field):
            try:
                v = float(value)
            except ValueError:
                raise ConfigError(f"field {field!r} must be a float, got {value!r}")
            _check_range(v, lo, hi, field, value)
            return v

        return check_float

    if spec.lower() == "bool":

        def check_bool(value, field):
            if value not in BOOL_SET:
                raise ConfigError(f"field {field!r} must be a boolean, got {value!r}")
            return to_bool(value)

        return check_bool

    if spec == "bool_list":

        def check_bool_list(value, field):
            out = []
            for v in value.split(","):
                if v not in BOOL_SET:
                    raise ConfigError(
                        f"field {field!r} must be a comma list of booleans, got {value!r}"
                    )
                out.append(to_bool(v))
            return out

        return check_bool_list

    if spec in ("str_list", "list_str"):
        return lambda value, field: value.split(",")

    if spec == "path":

        def check_path(value, field):
            if value != "none" and not os.path.exists(value):
                raise ConfigError(f"field {field!r}: path {value!r} does not exist")
            return value

        return check_path

    if spec == "str":
        return lambda value, field: value

    raise ConfigError(f"unknown type spec {spec!r}")


def validate_section(
    section: dict, proto_section: dict, section_name: str, allow_empty=("cmd",)
) -> dict:
    """Validate one INI section against a proto section; returns parsed values.

    Field names are matched case-insensitively (configparser lowercases keys;
    the reference's protos use e.g. `N_epochs_tr`).
    """
    parsed = {}
    proto_lc = {k.lower(): (k, v) for k, v in proto_section.items()}
    for key, raw in section.items():
        if key.lower() not in proto_lc:
            continue  # extra fields are allowed (arch options validated separately)
        _, spec = proto_lc[key.lower()]
        if raw == "" and key in allow_empty:
            parsed[key] = raw
            continue
        if raw == "":
            raise ConfigError(f"section [{section_name}]: field {key!r} is empty")
        parsed[key] = make_checker(spec)(raw, f"{section_name}.{key}")
    missing = [k for k in proto_lc if k not in {kk.lower() for kk in section.keys()}]
    if missing:
        raise ConfigError(
            f"section [{section_name}] is missing required fields: {sorted(missing)}"
        )
    return parsed


def expand_multiline_field(value: str) -> str:
    """Normalize a multi-line INI field (collapse repeated spaces per line)."""
    return "\n".join(re.sub(" +", " ", line) for line in value.split("\n"))
