"""convnext-b [vision]: img_res=224 depths=3-3-27-3 dims=128-256-512-1024.
[arXiv:2201.03545; paper]  (twin of ``repro/configs/convnext_b.py``)"""
from ..models import convnext
from ..models.convnext import ConvNeXtConfig
from .base import Arch, register, vision_cells

FULL = ConvNeXtConfig(name="convnext-b", img_res=224, depths=(3, 3, 27, 3),
                      dims=(128, 256, 512, 1024))
SMOKE = ConvNeXtConfig(name="convnext-b-smoke", img_res=64, depths=(2, 2, 6, 2),
                       dims=(32, 64, 96, 128), num_classes=10)

ARCH = register(
    Arch(
        name="convnext-b",
        family="vision",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=vision_cells(),
        module=convnext,
        notes="pure sliding-window net; 7x7 depthwise = widest halos in the "
        "pool -- flagship for the spatial engine",
    )
)
