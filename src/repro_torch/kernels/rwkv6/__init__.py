from .ops import wkv6, wkv6_decode_step
from .ref import wkv6_chunked, wkv6_ref

__all__ = ["wkv6", "wkv6_decode_step", "wkv6_ref", "wkv6_chunked"]
