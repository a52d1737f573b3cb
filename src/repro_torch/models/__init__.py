"""Model families on the Program path: the CNNs and the dense LMs."""
from . import cnn, transformer
from .common import ParamDef, init_params, params_from_numpy, tree_paths

__all__ = ["cnn", "transformer", "ParamDef", "init_params",
           "params_from_numpy", "tree_paths"]
