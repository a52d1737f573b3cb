from .ops import mamba2_decode_step, mamba2_scan
from .ref import mamba2_scan_chunked, mamba2_scan_ref

__all__ = ["mamba2_scan", "mamba2_decode_step", "mamba2_scan_ref",
           "mamba2_scan_chunked"]
