"""Deprecated-alias machinery (ref: python/src/ouster/sdk/_deprecation.py,
used by core/__init__.py's deprecated_alias calls)."""

from __future__ import annotations

import warnings
from typing import Any, Dict


def deprecated_alias(old_name: str, new_name: str, obj: Any,
                     namespace: Dict[str, Any],
                     since: str = "0.16.0") -> None:
    """Register ``old_name`` in ``namespace`` as a deprecation-warning
    alias for ``new_name``. Mirrors the reference helper: the alias is
    directly usable but warns on access when the module defines a
    ``__getattr__`` over its alias table."""
    table = namespace.setdefault("_deprecated_aliases", {})
    table[old_name] = (new_name, obj, since)


def make_module_getattr(namespace: Dict[str, Any]):
    """Build a PEP-562 module ``__getattr__`` that resolves registered
    deprecated aliases with a DeprecationWarning."""
    def __getattr__(name: str) -> Any:
        table = namespace.get("_deprecated_aliases", {})
        if name in table:
            new_name, obj, since = table[name]
            warnings.warn(
                f"{name} is deprecated since {since}; use {new_name}",
                DeprecationWarning, stacklevel=2)
            return obj
        raise AttributeError(
            f"module {namespace.get('__name__')!r} has no attribute "
            f"{name!r}")

    return __getattr__
