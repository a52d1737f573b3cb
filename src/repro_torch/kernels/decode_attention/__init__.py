from .ops import decode_attention, ring_kv_len, ring_positions
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "ring_kv_len",
           "ring_positions"]
