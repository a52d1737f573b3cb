"""Model families on the Program path: the CNNs, the dense and MoE LMs,
the zamba2 / mamba2 hybrid, rwkv6 and whisper.  Importing the package
registers every family's persistent-state hook
(``core.regions.register_state_family``)."""
from ..configs.archs import not_ported
from . import cnn, rwkv, transformer, whisper, zamba2
from .common import ParamDef, init_params, params_from_numpy, tree_paths

# family -> its parameter declaration (``repro``'s ``get_model(cfg)
# .param_defs``, for the families the port carries)
PARAM_DEFS = {"dense": transformer.param_defs,
              "moe": transformer.param_defs,
              "hybrid": zamba2.param_defs,
              "ssm": rwkv.param_defs,
              "audio": whisper.param_defs}

# family -> (the extra input its requests carry, the admission-time
# writer of the read-only persistent memory that input fills):
# ``repro``'s ``ModelApi.extra_input`` / ``encode_memory``
MEMORY_WRITERS = {"audio": ("encoder_frames", whisper.encode_memory)}


def param_defs(cfg) -> dict:
    """The ParamDef tree of an LM config, by its family."""
    if cfg.family not in PARAM_DEFS:
        raise not_ported(cfg.name, cfg.family)
    return PARAM_DEFS[cfg.family](cfg)


__all__ = ["cnn", "transformer", "zamba2", "rwkv", "whisper", "ParamDef",
           "init_params", "params_from_numpy", "tree_paths", "param_defs",
           "PARAM_DEFS", "MEMORY_WRITERS"]
