"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416.  [hf:Qwen/CodeQwen1.5-7B; hf]  (twin of
``repro/configs/codeqwen15_7b.py``)"""
from ..models import transformer_lm as lm
from ..models.transformer_lm import LMConfig
from .base import Arch, lm_cells, register

FULL = LMConfig(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=13440,
    vocab=92416,
    rope_theta=1e6,
)

SMOKE = LMConfig(
    name="codeqwen1.5-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    vocab=512,
)

ARCH = register(
    Arch(
        name="codeqwen1.5-7b",
        family="lm",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention=True),
        module=lm,
        notes="dense MHA; qwen1.5 arch",
    )
)
