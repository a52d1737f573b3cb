"""Multi-device: the sharding plan, the activation rules, the ring
collective matmuls and the int8 cross-pod sync (counterpart of
``repro/parallel``), over ``torch.distributed``.  ``placement`` maps the
plan's specs onto a ``DeviceMesh`` as DTensor placements; ``split`` runs
the dense family's serving steps split over "model"."""
from .act_sharding import (ActivationRules, P, activation_rules,
                           data_shards)
from .rules import STRATEGIES, ShardingPlan, make_plan
from .crosspod import (apply_error_feedback, compress_int8,
                       compressed_all_reduce, decompress_int8)
from .overlap import all_gather_matmul, matmul_reduce_scatter

__all__ = ["ActivationRules", "P", "activation_rules", "data_shards",
           "STRATEGIES", "ShardingPlan", "make_plan",
           "apply_error_feedback", "compress_int8", "compressed_all_reduce",
           "decompress_int8", "all_gather_matmul", "matmul_reduce_scatter"]
