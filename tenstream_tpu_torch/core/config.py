"""Hierarchical runtime options with per-subsolver prefixes (port of
`tenstream_tpu/core/config.py`).

Each solver scope gets a namespaced view on a shared store
(``opts.scoped("solar_dir_")``) whose lookups try ``prefix+key`` first,
then ``key``.  Values may be seeded from a CLI-ish string
(``-key value -flag``) or from ``TENSTREAM_TPU_OPTIONS``.

Parsing is strict: a boolean option must be a bool, 0/1 or one of
yes/no/true/false/on/off, and an integer option must hold an integral
value; anything else raises `ValueError` instead of being coerced.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

_TRUE = ("yes", "true", "on")
_FALSE = ("no", "false", "off")


def _parse_option_string(s: str) -> Dict[str, Any]:
    """Parse ``-key value -flag -other 1.5`` into a dict (PETSc-like)."""
    out: Dict[str, Any] = {}
    toks = s.split()
    i = 0
    while i < len(toks):
        tok = toks[i]
        if not tok.startswith("-"):
            raise ValueError(f"option string: stray value {tok!r}")
        key = tok.lstrip("-")
        if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
            out[key] = _coerce(toks[i + 1])
            i += 2
        else:
            out[key] = True
            i += 1
    return out


def _coerce(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    low = v.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    return v


class Options:
    """A flat key-value store with prefix-scoped views."""

    def __init__(
        self,
        values: Optional[Mapping[str, Any]] = None,
        option_string: Optional[str] = None,
        read_env: bool = True,
    ):
        self._store: Dict[str, Any] = {}
        if read_env:
            env = os.environ.get("TENSTREAM_TPU_OPTIONS", "")
            if env:
                self._store.update(_parse_option_string(env))
        if option_string:
            self._store.update(_parse_option_string(option_string))
        if values:
            self._store.update(dict(values))
        self._prefix = ""

    def __contains__(self, key: str) -> bool:
        return (self._prefix + key) in self._store or key in self._store

    def set(self, key: str, value: Any) -> None:
        self._store[self._prefix + key] = value

    def get(self, key: str, default: Any = None) -> Any:
        """Prefixed lookup with fallback to the unprefixed key."""
        pk = self._prefix + key
        if pk in self._store:
            return self._store[pk]
        if key in self._store:
            return self._store[key]
        return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        if isinstance(v, int) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _TRUE + _FALSE:
            return v.lower() in _TRUE
        raise ValueError(f"option {key!r}: {v!r} is not a boolean")

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key, default)
        if isinstance(v, bool):
            raise ValueError(f"option {key!r}: {v!r} is not a number")
        return float(v)

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key, default)
        if isinstance(v, bool):
            raise ValueError(f"option {key!r}: {v!r} is not an integer")
        f = float(v)
        if f != int(f):
            raise ValueError(f"option {key!r}: {v!r} is not an integer")
        return int(f)

    def scoped(self, prefix: str) -> "Options":
        """A view whose lookups try ``prefix+key`` first, then ``key``."""
        view = Options.__new__(Options)
        view._store = self._store
        view._prefix = self._prefix + prefix
        return view

    def __repr__(self) -> str:  # pragma: no cover
        return f"Options(prefix={self._prefix!r}, store={self._store!r})"
