from .ops import attention_block_sizes, flash_attention
from .ref import flash_ref

__all__ = ["flash_attention", "attention_block_sizes", "flash_ref"]
