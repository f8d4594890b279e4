"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6.  [hf:moonshotai/Moonlight-16B-A3B; hf]  (twin of
``repro/configs/moonshot_v1_16b_a3b.py``)"""
from ..models import transformer_lm as lm
from ..models.moe import MoEConfig
from ..models.transformer_lm import LMConfig
from .base import Arch, lm_cells, register

FULL = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=163840,
    rope_theta=1e6,
    moe=MoEConfig(d_model=2048, n_experts=64, top_k=6, d_ff=1408, n_shared=0),
)

SMOKE = LMConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff=96, capacity_factor=2.0),
)

ARCH = register(
    Arch(
        name="moonshot-v1-16b-a3b",
        family="lm",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention=True),
        module=lm,
        notes="all-MoE (64e top-6, per-expert ff 1408); expert parallelism on "
        "the model axis",
    )
)
