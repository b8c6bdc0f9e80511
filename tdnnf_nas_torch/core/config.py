"""Numpy/stdlib copy of ``tdnnf_nas_tpu.core.config`` (typed config base
and its JSON round trip, `core/config.py:21-82` there)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Type, TypeVar

T = TypeVar("T")


class Config:
    """Marker base class for the port's config dataclasses.

    Subclasses must be ``@dataclasses.dataclass``; ``replace`` returns a
    copy with the given fields changed.  Nested Config fields round-trip
    through :func:`asdict_config` / :func:`config_from_dict` and JSON.
    """

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(asdict_config(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls: Type[T], s: str) -> T:
        return config_from_dict(cls, json.loads(s))


def asdict_config(cfg: Any) -> Any:
    """Plain dicts and lists of a (nested) config, as JSON takes them."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: asdict_config(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [asdict_config(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: asdict_config(v) for k, v in cfg.items()}
    return cfg


def _tuples(v: Any) -> Any:
    """JSON lists back to the tuples the port's frozen configs hold."""
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def _nested_config_type(f: dataclasses.Field):
    """The config class of a field whose default is a config, else None
    (annotations are strings under ``from __future__ import
    annotations``, so the default says what the field holds)."""
    if dataclasses.is_dataclass(f.type):
        return f.type
    if f.default is not dataclasses.MISSING:
        proto = f.default
    elif f.default_factory is not dataclasses.MISSING:
        proto = f.default_factory()
    else:
        return None
    return type(proto) if dataclasses.is_dataclass(proto) else None


def config_from_dict(cls: Type[T], d: Any) -> T:
    """Rebuild a (possibly nested) config dataclass from plain dicts.

    Unlike the reference, which keeps JSON lists as lists, lists come back
    as tuples, so a config equals itself after the round trip.
    """
    if not (dataclasses.is_dataclass(cls) and isinstance(d, dict)):
        return d
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for name, val in d.items():
        if name not in fields:
            raise ValueError(
                f"unknown config field {name!r} for {cls.__name__}")
        target = _nested_config_type(fields[name])
        if target is not None and isinstance(val, dict):
            kw[name] = config_from_dict(target, val)
        else:
            kw[name] = _tuples(val)
    return cls(**kw)
