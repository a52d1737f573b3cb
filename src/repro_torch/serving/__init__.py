"""Serving: the batched engine (CNN Program path so far)."""
from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
