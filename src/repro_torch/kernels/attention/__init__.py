from .ops import flash_attention, gqa_flash
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "gqa_flash"]
