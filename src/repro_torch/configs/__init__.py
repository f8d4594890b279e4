"""Config registry (twin of ``repro/configs``): one module per architecture
the port runs.  ``get(name)`` / ``list_archs()`` trigger registration lazily.
"""
from .base import Arch, Cell, REGISTRY, get, list_archs, lm_cells  # noqa: F401

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import codeqwen15_7b, deepseek_v3_671b, moonshot_v1_16b_a3b, qwen3_4b  # noqa: F401

    _LOADED = True
