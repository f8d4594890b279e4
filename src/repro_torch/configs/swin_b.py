"""swin-b [vision]: img_res=224 patch=4 window=7 depths=2-2-18-2
dims=128-256-512-1024.  [arXiv:2103.14030; paper]  (twin of
``repro/configs/swin_b.py``)"""
from ..models import swin
from ..models.swin import SwinConfig
from .base import Arch, register, vision_cells

FULL = SwinConfig(name="swin-b", img_res=224, patch=4, window=7,
                  depths=(2, 2, 18, 2), dims=(128, 256, 512, 1024),
                  n_heads=(4, 8, 16, 32))
SMOKE = SwinConfig(name="swin-b-smoke", img_res=64, patch=4, window=4,
                   depths=(2, 2), dims=(32, 64), n_heads=(2, 4), num_classes=10)

ARCH = register(
    Arch(
        name="swin-b",
        family="vision",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=vision_cells(),
        module=swin,
        notes="bounded receptive field (7x7 windows): shifted windows need a "
        "one-window halo -- the transformer analogue of HALP's boundary "
        "exchange (cls_384 uses window 12)",
    )
)
