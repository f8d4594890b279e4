"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MLA, 1 shared + 256 routed top-8, MTP.  [arXiv:2412.19437; hf]
(twin of ``repro/configs/deepseek_v3_671b.py``)

Structural details from the paper: first 3 layers dense (d_ff 18432), MLA with
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128, MTP depth 1.
"""
from ..models import transformer_lm as lm
from ..models.attention import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer_lm import LMConfig
from .base import Arch, lm_cells, register

FULL = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,  # dense layers (first 3)
    vocab=129280,
    rope_theta=1e4,
    attn="mla",
    mla=MLAConfig(d_model=7168, n_heads=128),
    moe=MoEConfig(d_model=7168, n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  router_bias=True),
    first_k_dense=3,
    mtp_depth=1,
)

SMOKE = LMConfig(
    name="deepseek-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=192,
    vocab=512,
    attn="mla",
    mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff=96, n_shared=1,
                  router_bias=True, capacity_factor=2.0),
    first_k_dense=1,
    mtp_depth=1,
)

ARCH = register(
    Arch(
        name="deepseek-v3-671b",
        family="lm",
        cfg=FULL,
        smoke_cfg=SMOKE,
        cells=lm_cells(full_attention=True),
        module=lm,
        notes="MLA compressed KV cache (576/token); 256-way EP; bf16 optimizer "
        "moments to fit 512 x 16 GB (DESIGN.md memory budget)",
    )
)
