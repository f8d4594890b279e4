"""Config registry (twin of ``repro/configs``): one module per architecture
the port runs.  ``get(name)`` / ``list_archs()`` trigger registration lazily.
"""
from .base import Arch, Cell, REGISTRY, diffusion_cells, get, list_archs, lm_cells, vision_cells  # noqa: F401

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        codeqwen15_7b,
        convnext_b,
        deepseek_v3_671b,
        dit_xl2,
        efficientnet_b7,
        moonshot_v1_16b_a3b,
        qwen3_4b,
        swin_b,
        unet_sd15,
        vgg16,
        vit_l16,
    )

    _LOADED = True
