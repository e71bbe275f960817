"""Lazy re-exports for the port's subpackages.

Each subpackage exports ``fit_tpu``'s public names of the same subpackage,
but importing the subpackage must stay cheap and free of import cycles
(``utils.checkpoint`` needs ``train.state``, ``train.loop`` needs
``utils.checkpoint``). So a name is looked up in its module at first access,
through the package's module ``__getattr__`` (PEP 562).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, List, Tuple


def lazy_exports(package: str, sources: Dict[str, Iterable[str]]) -> Tuple[List[str], Callable, Callable]:
    """``(__all__, __getattr__, __dir__)`` for ``package``, whose names come
    from the modules of ``sources`` (module name relative to the package ->
    the names it gives)."""
    where = {name: module for module, names in sources.items() for name in names}

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(where[name], package), name)

    def __dir__() -> List[str]:
        return sorted(set(where) | set(importlib.import_module(package).__dict__))

    return list(where), __getattr__, __dir__
