"""Uniform model API (counterpart of ``repro/models/registry.py``):
family -> its parameter declaration, legacy forward, cache init and
decode step, the extra input its requests carry and the admission-time
writer of the read-only persistent memory that input fills.  The one
table that knows each LM family; launchers, the engine and the tests
go through it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..configs.base import ArchConfig
from . import rwkv, transformer, whisper, zamba2

__all__ = ["ModelApi", "get_model", "FAMILIES"]


@dataclass(frozen=True)
class ModelApi:
    param_defs: Callable[[ArchConfig], dict]
    forward: Callable[..., dict]
    init_cache: Callable[..., dict]
    decode_step: Callable[..., tuple]
    extra_input: str | None = None   # "vision_embeds" | "encoder_frames"
    # Admission-time writer for families whose decode Program reads
    # *read-only* persistent memory (whisper: encoder cross K/V): called
    # once per admitted request with the request's extra input, it
    # returns {persistent region name: per-slot row} for the engine to
    # copy in at the admitted slot.
    encode_memory: Callable[..., dict] | None = None


FAMILIES: dict[str, ModelApi] = {
    "dense": ModelApi(transformer.param_defs, transformer.forward,
                      transformer.init_cache, transformer.decode_step),
    "moe": ModelApi(transformer.param_defs, transformer.forward,
                    transformer.init_cache, transformer.decode_step),
    "vlm": ModelApi(transformer.param_defs, transformer.forward,
                    transformer.init_cache, transformer.decode_step,
                    extra_input="vision_embeds"),
    "audio": ModelApi(whisper.param_defs, whisper.forward,
                      whisper.init_cache, whisper.decode_step,
                      extra_input="encoder_frames",
                      encode_memory=whisper.encode_memory),
    "hybrid": ModelApi(zamba2.param_defs, zamba2.forward,
                       zamba2.init_cache, zamba2.decode_step),
    "ssm": ModelApi(rwkv.param_defs, rwkv.forward, rwkv.init_cache,
                    rwkv.decode_step),
}


def get_model(cfg: ArchConfig) -> ModelApi:
    return FAMILIES[cfg.family]
