"""vit-l16 [vision]: img_res=224 patch=16 n_layers=24 d_model=1024 n_heads=16
d_ff=4096.  [arXiv:2010.11929; paper]  (twin of ``repro/configs/vit_l16.py``)"""
from ..models import vit
from ..models.vit import ViTConfig
from .base import Arch, register, vision_cells

FULL = ViTConfig(name="vit-l16", img_res=224, patch=16, n_layers=24,
                 d_model=1024, n_heads=16, d_ff=4096)
SMOKE = ViTConfig(name="vit-l16-smoke", img_res=64, patch=8, n_layers=2,
                  d_model=64, n_heads=4, d_ff=128, num_classes=10)

ARCH = register(
    Arch(
        name="vit-l16",
        family="vision",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=vision_cells(),
        module=vit,
        notes="conv stem is partitionable; global attention makes per-layer "
        "receptive field unbounded -> DP/TP (DESIGN.md §4)",
    )
)
