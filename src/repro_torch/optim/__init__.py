from .adamw import (AdamW, LeafShards, Q8State, cosine_schedule,
                    dequantize_state, global_norm, quantize_state)

__all__ = ["AdamW", "LeafShards", "Q8State", "cosine_schedule",
           "dequantize_state", "global_norm", "quantize_state"]
