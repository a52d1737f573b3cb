"""Model families on the Program path: the CNNs, the dense and MoE LMs,
the zamba2 / mamba2 hybrid and rwkv6.  Importing the package registers every
family's persistent-state hook (``core.regions.register_state_family``)."""
from . import cnn, rwkv, transformer, zamba2
from .common import ParamDef, init_params, params_from_numpy, tree_paths

# family -> its parameter declaration (``repro``'s ``get_model(cfg)
# .param_defs``, for the families the port carries)
PARAM_DEFS = {"dense": transformer.param_defs,
              "moe": transformer.param_defs,
              "hybrid": zamba2.param_defs,
              "ssm": rwkv.param_defs}


def param_defs(cfg) -> dict:
    """The ParamDef tree of an LM config, by its family."""
    if cfg.family not in PARAM_DEFS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet (ROADMAP A.9)")
    return PARAM_DEFS[cfg.family](cfg)


__all__ = ["cnn", "transformer", "zamba2", "rwkv", "ParamDef",
           "init_params", "params_from_numpy", "tree_paths", "param_defs",
           "PARAM_DEFS"]
