from .adamw import (AdamW, Q8State, cosine_schedule, dequantize_state,
                    global_norm, quantize_state)

__all__ = ["AdamW", "Q8State", "cosine_schedule", "dequantize_state",
           "global_norm", "quantize_state"]
