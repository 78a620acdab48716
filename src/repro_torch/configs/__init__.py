"""Architecture configs the port serves (``--arch <id>``).

Each module defines ``SPEC`` (the published configuration) and ``REDUCED``
(a small same-family config for CPU tests), copied from ``repro.configs``.
"""

from . import registry
from .registry import ARCH_IDS, get_reduced, get_spec

__all__ = ["registry", "ARCH_IDS", "get_spec", "get_reduced"]
