"""Model families: the CNNs and every LM family of the reference -- dense
and MoE, the zamba2 / mamba2 hybrid, rwkv6, whisper and the vlm
(llama-3.2-vision).  ``registry.FAMILIES`` is the one table of each LM
family's entry points.  Importing the package registers every family's
persistent-state hook (``core.regions.register_state_family``)."""
from . import cnn, rwkv, transformer, whisper, zamba2
from .common import (ParamDef, abstract_params, init_params, param_pspecs,
                     params_from_numpy, tree_paths)
from .registry import FAMILIES, ModelApi, get_model


def param_defs(cfg) -> dict:
    """The ParamDef tree of an LM config, by its family."""
    return get_model(cfg).param_defs(cfg)


__all__ = ["cnn", "transformer", "zamba2", "rwkv", "whisper", "ParamDef",
           "abstract_params", "param_pspecs", "init_params",
           "params_from_numpy", "tree_paths", "param_defs", "FAMILIES",
           "ModelApi", "get_model"]
