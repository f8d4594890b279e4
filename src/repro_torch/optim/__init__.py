"""Optimizer of the port's trainer (twin of ``repro/optim``): AdamW, the
learning-rate schedules and the gradient compressors, as functions of
tensor trees that return new tensors."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .grad_compress import compress_bf16, compress_topk, decompress_bf16, topk_sparsify
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_bf16",
    "compress_topk",
    "constant",
    "decompress_bf16",
    "global_norm",
    "topk_sparsify",
    "warmup_cosine",
]
