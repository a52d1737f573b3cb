from .ops import (decode_attention, gather_pages, paged_decode_attention,
                  ring_kv_len, ring_positions)
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref",
           "paged_decode_attention", "gather_pages", "ring_kv_len",
           "ring_positions"]
