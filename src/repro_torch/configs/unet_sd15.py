"""unet-sd15 [diffusion]: img_res=512 latent_res=64 ch=320 ch_mult=1-2-4-4
n_res_blocks=2 attn_res=4-2-1 ctx_dim=768.  [arXiv:2112.10752; paper]
(twin of ``repro/configs/unet_sd15.py``)"""
from ..models import unet
from ..models.unet import UNetConfig
from .base import Arch, diffusion_cells, register

FULL = UNetConfig(name="unet-sd15", img_res=512, ch=320, ch_mult=(1, 2, 4, 4),
                  n_res_blocks=2, attn_down=(1, 2, 4), ctx_dim=768)
SMOKE = UNetConfig(name="unet-sd15-smoke", img_res=64, ch=32, ch_mult=(1, 2),
                   n_res_blocks=1, attn_down=(1, 2), ctx_dim=32, ctx_len=7,
                   n_heads=4, groups=8)

ARCH = register(
    Arch(
        name="unet-sd15",
        family="diffusion",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=diffusion_cells(),
        module=unet,
        notes="conv path is sliding-window (paper partitioning direct); "
        "attention levels synchronise spatially",
    )
)
