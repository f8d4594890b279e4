"""dit-xl2 [diffusion]: img_res=256 patch=2 n_layers=28 d_model=1152
n_heads=16.  [arXiv:2212.09748; paper]  (twin of ``repro/configs/dit_xl2.py``)"""
from ..models import dit
from ..models.dit import DiTConfig
from .base import Arch, diffusion_cells, register

FULL = DiTConfig(name="dit-xl2", img_res=256, patch=2, n_layers=28,
                 d_model=1152, n_heads=16)
SMOKE = DiTConfig(name="dit-xl2-smoke", img_res=64, patch=2, n_layers=2,
                  d_model=64, n_heads=4, num_classes=10)

ARCH = register(
    Arch(
        name="dit-xl2",
        family="diffusion",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=diffusion_cells(),
        module=dit,
        notes="latent diffusion transformer; gen shapes spatially shard the "
        "latent height over the data axis (HALP SP applied to serving)",
    )
)
