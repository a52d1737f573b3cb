"""Model families on the Program path (CNNs so far)."""
from . import cnn
from .common import ParamDef, init_params, params_from_numpy, tree_paths

__all__ = ["cnn", "ParamDef", "init_params", "params_from_numpy",
           "tree_paths"]
