"""Core compiler, copied from ``repro.core`` (pure Python).

Pipeline:  ModelGraph (ir) -> tiles (tiling) -> loop order (dataflow)
        -> balance (balance) -> ModelSchedule (schedule)
        -> regions (regions) -> Program (program) -> runtime/executor.

The hardware models are the reference's (``TPU_V5E``, ``SNOWFLAKE``),
so a Program compiled here lists byte for byte like ``repro``'s.
``quant`` carries the reference's module: the §5.3 fixed-point oracle
and the int8 half the paged KV pools use.  ``cost`` (the measured cost
model) and ``autotune`` (stage 7: trace, calibrate, replay, pin) are
the reference's, with the device's clock on the card; they are
imported as submodules (``autotune`` reaches the executor).  So are
the dry-run's: ``roofline`` (the reference's three-term roofline and
ring-algorithm link bytes) and ``step_analysis``, which stands where
the reference's ``hlo_analysis`` does and counts one eager call of a
step in place of parsing HLO.
"""
from .hw import (HardwareModel, MeshDescriptor, MULTI_POD, SINGLE_POD,
                 SNOWFLAKE, TPU_V5E)
from .ir import (DepLabel, LayerKind, LayerNode, ModelGraph, conv_node,
                 matmul_node)
from .tiling import (ConvTiling, MatmulTiling, select_conv_row_strips,
                     select_matmul_tiles)
from .dataflow import (Dataflow, DataflowDecision, DistDecision,
                       DistStrategy, choose_dist_strategy,
                       choose_matmul_dataflow, matmul_traffic)
from .balance import (assign_lpt, balance_transfers, moe_capacity,
                      percent_imbalance, split_transfer)
from .schedule import LayerSchedule, ModelSchedule, compile_model
from .regions import Region, RegionPlan, allocate_regions
from .program import Program, ProgramOp, lower_to_program

__all__ = [n for n in dir() if not n.startswith("_")]
