"""Config system: one dataclass tree + flat dotted-key CLI overrides.

A copy of ``distributed_tensorflow_tpu/utils/config.py`` (framework-free
there too): the port imports nothing of the JAX package, whose
``__init__`` imports jax, so it keeps its own.

Replaces the reference's per-script flag layer (SURVEY.md §5.6: tf.app.flags
``--ps_hosts/--worker_hosts/--job_name/--task_index/--sync_replicas/...`` +
the TF_CONFIG env var). Topology flags become the mesh section (axis sizes,
not host:port lists); every run serializes its resolved config into the
checkpoint directory for reproducibility.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def to_json(cfg: Any, **kwargs) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True, **kwargs)


def from_dict(cls: Type[T], d: Any) -> T:
    """Rebuild a dataclass tree from a plain dict (checkpoint restore)."""
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            raise ValueError(f"Unknown config field '{k}' for {cls.__name__}")
        ftype = fields[k].type
        ftype = _resolve_type(ftype, cls)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[k] = from_dict(ftype, v)
        elif (get_origin(ftype) is tuple or ftype is tuple) and isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _resolve_type(ftype, owner_cls):
    if isinstance(ftype, str):
        import builtins
        import sys
        import typing

        mod = sys.modules.get(owner_cls.__module__)
        ns = {**vars(builtins), **vars(typing)}
        if mod is not None:
            ns.update(vars(mod))
        ftype = eval(ftype, ns)  # annotations from our own dataclasses
    # unwrap Optional[X]
    args = [a for a in get_args(ftype) if a is not type(None)]
    if get_origin(ftype) is not None and len(args) == 1 and get_origin(ftype) not in (tuple, list, dict):
        return args[0]
    return ftype


def _parse_value(raw: str, ftype) -> Any:
    # callers pass an already-resolved ftype (see _replace_path)
    if ftype is bool or (isinstance(ftype, type) and issubclass(ftype, bool)):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"Not a bool: {raw!r}")
    if raw.lower() == "none":
        return None  # before numeric parse, so Optional[int]=none works
    try:
        if isinstance(ftype, type) and issubclass(ftype, int) and not issubclass(ftype, bool):
            return int(raw)
        if isinstance(ftype, type) and issubclass(ftype, float):
            return float(raw)
    except TypeError:
        pass
    # tuples / lists / anything json-ish
    is_tuple = get_origin(ftype) is tuple or ftype is tuple
    # raw[:1] must be non-empty before the membership test: "" is a
    # substring of every string, so a bare `--key=` (empty value, e.g.
    # --checkpoint.directory= to disable) would wrongly take the strict
    # JSON branch and crash instead of falling through to a raw string
    if (is_tuple or get_origin(ftype) is list or ftype is list
            or (raw[:1] and raw[:1] in "[({")):
        val = json.loads(raw)
        return tuple(val) if is_tuple else val
    # fall back on literal parse, then raw string
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """``apply_overrides(cfg, ["train.lr=0.1", "mesh.model=4"])``.

    The TPU-native stand-in for the reference's flag parsing: one flat
    namespace over the whole tree, type-checked against the dataclass
    field, first path component selects the section.
    """
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        key = key.lstrip("-")
        path = key.split(".")
        cfg = _replace_path(cfg, path, raw, key)
    return cfg


def _replace_path(node: Any, path: list[str], raw: str, full_key: str):
    name, rest = path[0], path[1:]
    if not dataclasses.is_dataclass(node):
        raise ValueError(f"Cannot descend into non-config at '{full_key}'")
    fields = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields:
        valid = ", ".join(sorted(fields))
        raise ValueError(f"Unknown config key '{full_key}' (at '{name}'; valid: {valid})")
    if rest:
        child = _replace_path(getattr(node, name), rest, raw, full_key)
        return dataclasses.replace(node, **{name: child})
    ftype = _resolve_type(fields[name].type, type(node))
    value = _parse_value(raw, ftype)
    return dataclasses.replace(node, **{name: value})


def parse_argv(cfg: T, argv: Sequence[str]) -> T:
    """Parse ``--a.b=c``-style argv into config overrides."""
    return apply_overrides(cfg, [a for a in argv if a.startswith("--") and "=" in a])
