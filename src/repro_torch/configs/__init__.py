"""Architecture configs (``--arch <id>``), copied from ``repro.configs``.

Each module defines ``SPEC`` (the published configuration) and ``REDUCED``
(a small same-family config for CPU tests).  ``registry.get_spec`` also
resolves the paper's Table-IV models by name, for the analytical side.
"""

from . import registry
from .registry import ARCH_IDS, get_reduced, get_spec

__all__ = ["registry", "ARCH_IDS", "get_spec", "get_reduced"]
