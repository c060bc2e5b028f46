"""Config system: `key = value` text files with CLI override merge.

Parity with the reference's config path (learn/base/arg_parser.h:36-60):
a conf file of `key = value` lines merged with later `key=value` CLI
args, args winning. Values are typed by the dataclass schema each learner
declares. Repeated keys accumulate into lists (protobuf repeated-field
semantics). The same conf files drive the JAX package and this port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, get_args, get_origin


def parse_conf_text(text: str) -> dict[str, list[str]]:
    """Parse `key = value` lines; '#' comments; repeated keys accumulate."""
    out: dict[str, list[str]] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line:
            k, v = line.split("=", 1)
        elif ":" in line:
            k, v = line.split(":", 1)
        else:
            raise ValueError(f"bad config line: {raw!r}")
        v = v.strip()
        if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
            v = v[1:-1]
        out.setdefault(k.strip(), []).append(v)
    return out


def parse_argv(argv: list[str]) -> dict[str, list[str]]:
    """Parse `key=value` CLI tokens (reference rabit-style SetParam args and
    the PS apps' trailing-arg merge, arg_parser.h:41-44)."""
    out: dict[str, list[str]] = {}
    for tok in argv:
        if "=" not in tok:
            raise ValueError(f"expected key=value, got {tok!r}")
        k, v = tok.split("=", 1)
        out.setdefault(k.strip().lstrip("-"), []).append(v.strip())
    return out


def _convert(val: str, typ) -> Any:
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def load_config(cls, conf_file: Optional[str] = None, argv: Optional[list[str]] = None):
    """Build a dataclass config: defaults <- conf file <- CLI args."""
    merged: dict[str, list[str]] = {}
    if conf_file:
        with open(conf_file) as f:
            for k, vs in parse_conf_text(f.read()).items():
                merged[k] = vs
    if argv:
        for k, vs in parse_argv(argv).items():
            merged.setdefault(k, [])
            merged[k] = merged[k] + vs if _is_repeated(cls, k) else vs
    return apply_config(cls, merged)


def _resolve_type(typ):
    if isinstance(typ, str):  # from __future__ annotations
        typ = eval(typ, {"Optional": Optional, "list": list, "str": str,
                         "int": int, "float": float, "bool": bool})
    return typ


def _is_repeated(cls, key: str) -> bool:
    for f in dataclasses.fields(cls):
        if f.name == key:
            return get_origin(_resolve_type(f.type)) is list
    return False


def apply_config(cls, kv: dict[str, list[str]]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    unknown = []
    for k, vs in kv.items():
        f = fields.get(k)
        if f is None:
            unknown.append(k)
            continue
        typ = _resolve_type(f.type)
        origin = get_origin(typ)
        if origin is list:
            (elem,) = get_args(typ)
            kwargs[k] = [_convert(v, elem) for v in vs]
        elif origin is not None and type(None) in get_args(typ):  # Optional[T]
            elem = [a for a in get_args(typ) if a is not type(None)][0]
            kwargs[k] = _convert(vs[-1], elem)
        else:
            kwargs[k] = _convert(vs[-1], typ)
    if unknown:
        raise ValueError(f"unknown config keys: {unknown} for {cls.__name__}")
    return cls(**kwargs)
