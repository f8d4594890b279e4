"""efficientnet-b7 [vision]: img_res=600 width_mult=2.0 depth_mult=3.1.
[arXiv:1905.11946; paper]  (twin of ``repro/configs/efficientnet_b7.py``)"""
from ..models import efficientnet
from ..models.efficientnet import EfficientNetConfig
from .base import Arch, register, vision_cells

FULL = EfficientNetConfig(name="efficientnet-b7", img_res=600,
                          width_mult=2.0, depth_mult=3.1)
SMOKE = EfficientNetConfig(name="efficientnet-b7-smoke", img_res=64,
                           width_mult=0.25, depth_mult=0.35, num_classes=10)

ARCH = register(
    Arch(
        name="efficientnet-b7",
        family="vision",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=vision_cells(),
        module=efficientnet,
        notes="MBConv+SE; HALP partitioning applies layer-wise, the SE global "
        "pool is the one cross-segment sync (DESIGN.md §4)",
    )
)
