"""vgg16 -- the paper's own evaluation model (not part of the assigned pool;
used by the HALP reproduction benchmarks and examples).  (twin of
``repro/configs/vgg16.py``)"""
from ..models import vgg
from .base import Arch, Cell, register

ARCH = register(
    Arch(
        name="vgg16",
        family="convnet",
        cfg=vgg.FULL,
        smoke_cfg=vgg.SMOKE,
        cells={
            "halp_224": Cell("halp_224", "serve", {"img_res": 224, "batch": 1}),
        },
        module=vgg,
        notes="paper model; served through the HALP spatial engine",
    )
)
