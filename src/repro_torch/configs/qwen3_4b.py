"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, head_dim=128.  [hf:Qwen/Qwen3-8B family; hf]  (twin of
``repro/configs/qwen3_4b.py``)"""
from ..models import transformer_lm as lm
from ..models.transformer_lm import LMConfig
from .base import Arch, lm_cells, register

FULL = LMConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = LMConfig(
    name="qwen3-4b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    qk_norm=True,
)

ARCH = register(
    Arch(
        name="qwen3-4b",
        family="lm",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention=True),
        module=lm,
        notes="dense GQA with qk-norm; HALP spatial partitioning inapplicable "
        "(unbounded receptive field) -- runs DP/TP, see DESIGN.md §4",
    )
)
