"""Numpy/stdlib copy of ``tdnnf_nas_tpu.core.config`` (typed config base)."""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")


class Config:
    """Marker base class for the port's config dataclasses.

    Subclasses must be ``@dataclasses.dataclass``; ``replace`` returns a
    copy with the given fields changed.
    """

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)
