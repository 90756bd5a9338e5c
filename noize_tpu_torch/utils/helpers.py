"""Misc utilities — port of ``noize_tpu.utils.helpers``: ``Helpers.Fill``
and ``PropMapper`` parity.

Reference: ``Helpers.Fill<T>`` (Utils/Helpers/helpers.cs:5-21, a doubling
array fill) and ``PropMapper`` (Utils/Helpers/PropMapper.cs:36-105, a
reflection-free property copier used to clone inspector configs).  The
reference's ``match_vma`` casts ``shard_map`` varying axes and has no
meaning without JAX's manual mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def fill(array, count: int, value):
    """Fill the first ``count`` entries of ``array`` (a tensor or NumPy
    array) with ``value``, in place; returns ``array``."""
    array[:count] = value
    return array


def copy_props(src: Any, dst: Any, only_shared: bool = True):
    """PropMapper analog: copy matching public fields between two config
    objects (dataclasses or plain attribute bags); returns dst (a new
    instance for frozen dataclasses)."""
    if dataclasses.is_dataclass(dst):
        names = {f.name for f in dataclasses.fields(dst)}
        updates = {}
        for n in names:
            if hasattr(src, n):
                updates[n] = getattr(src, n)
            elif not only_shared:
                raise AttributeError(f"source missing field {n!r}")
        return dataclasses.replace(dst, **updates)
    for n in vars(dst):
        if n.startswith("_"):
            continue
        if hasattr(src, n):
            setattr(dst, n, getattr(src, n))
        elif not only_shared:
            raise AttributeError(f"source missing field {n!r}")
    return dst
