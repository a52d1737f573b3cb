"""Hardware models.

The paper's compiler reasons about one accelerator (Snowflake on a Zynq
XC7Z045).  This framework generalizes the same decision inputs — peak
compute, off-chip bandwidth, on-chip buffer capacity, number of load
streams — into a ``HardwareModel`` consumed by the tiling engine
(core/tiling.py), the loop-order cost model (core/dataflow.py), the load
balancer (core/balance.py) and the roofline calculator (core/roofline.py).

Two concrete models ship:

* ``TPU_V5E`` — the deployment target for this repo (kernels, dry-run,
  roofline).  Constants follow the assignment spec: 197 TFLOP/s bf16,
  819 GB/s HBM, ~50 GB/s/link ICI.
* ``SNOWFLAKE`` — the paper's FPGA accelerator, used by the benchmark
  suite to reproduce the paper's Tables 1-3 and Figure 4 analytically.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = [
    "HardwareModel",
    "MeshDescriptor",
    "TPU_V5E",
    "SNOWFLAKE",
    "SINGLE_POD",
    "MULTI_POD",
]


@dataclass(frozen=True)
class HardwareModel:
    """Per-chip hardware constants used by every compiler decision."""

    name: str
    # Compute.
    peak_flops: float            # FLOP/s at the native compute dtype
    compute_dtype_bytes: int     # bytes of the MAC operand dtype
    # Off-chip memory.
    hbm_bandwidth: float         # bytes/s
    hbm_bytes: int               # capacity
    # On-chip memory (VMEM on TPU; MBuf/WBuf on Snowflake).
    vmem_bytes: int              # usable scratch capacity per core
    vmem_budget_frac: float      # fraction the tiler may claim (double
                                 # buffering is accounted separately)
    # Compute-unit geometry (MXU on TPU; vMAC on Snowflake).
    mxu_dim: int                 # preferred contraction/output multiple
    sublane: int                 # second-minor tiling multiple (f32)
    lane: int                    # minor tiling multiple
    # Interconnect (ICI on TPU; the AXI ports on the Zynq).
    ici_bandwidth: float         # bytes/s per link
    ici_links_per_axis: int      # usable links per mesh axis (torus: 2)
    # Split on-chip buffers (Snowflake's MBuf/WBuf are separate; 0 means
    # a unified scratch, as on TPU where VMEM is one pool).
    maps_buffer_bytes: int = 0
    weights_buffer_bytes: int = 0
    # Load/store streams (the paper's 4 load units; informs chunking).
    load_units: int = 4
    # Whether the memory system supports random (strided, in-buffer)
    # access to a resident maps block.  Snowflake's DMA engine issues
    # contiguous single-burst loads only, so halo overlap must be
    # duplicated in DRAM (materialized strips); TPUs can gather
    # virtual strips out of VMEM for free.
    random_buffer_access: bool = True
    # Vector-instruction latency model (paper §5.2: bookkeeping must hide
    # under MAC latency).  Expressed as FLOPs one "instruction slot" of
    # epilogue work costs relative to the main loop.
    epilogue_slot_flops: float = 0.0

    # ---- derived quantities -------------------------------------------------
    @property
    def machine_balance(self) -> float:
        """FLOP per HBM byte needed to be compute bound."""
        return self.peak_flops / self.hbm_bandwidth

    def compute_time(self, flops: float) -> float:
        return flops / self.peak_flops

    def memory_time(self, bytes_moved: float) -> float:
        return bytes_moved / self.hbm_bandwidth

    def exec_time(self, flops: float, bytes_moved: float) -> float:
        """Overlapped execution model: DMA hides under compute (paper §3,
        double-buffer strategy), so a layer costs the max of the two."""
        return max(self.compute_time(flops), self.memory_time(bytes_moved))

    def vmem_budget(self) -> int:
        return int(self.vmem_bytes * self.vmem_budget_frac)

    def replace(self, **kw) -> "HardwareModel":
        return dataclasses.replace(self, **kw)


# --- TPU v5e: the deployment target ------------------------------------------
TPU_V5E = HardwareModel(
    name="tpu_v5e",
    peak_flops=197e12,             # bf16 MXU peak (assignment constant)
    compute_dtype_bytes=2,
    hbm_bandwidth=819e9,           # assignment constant
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
    vmem_budget_frac=0.75,         # leave room for the pipeline emitter
    mxu_dim=128,
    sublane=8,
    lane=128,
    ici_bandwidth=50e9,            # assignment constant, per link
    ici_links_per_axis=2,          # 2D torus: two directions per axis
    load_units=4,                  # DMA streams we chunk against
    epilogue_slot_flops=8.0,
)

# --- Snowflake (paper hardware), for the benchmark reproductions -------------
# 4 CUs x 4 vMACs x 16 MACs = 256 MACs; 2 FLOP/MAC/cycle @ 250 MHz = 128 GOP/s.
# ZC706 AXI bandwidth 4.2 GB/s bi-directional (paper §6.2).
# MBuf: 64 KB per maps bank (double banked per CU); WBuf: 8 KB per vMAC.
SNOWFLAKE = HardwareModel(
    name="snowflake",
    peak_flops=256 * 2 * 250e6,    # 128 GOP/s (16-bit MACs)
    compute_dtype_bytes=2,         # Q8.8
    hbm_bandwidth=4.2e9,
    hbm_bytes=1 * 2**30,           # ZC706 DDR visible via CMA
    vmem_bytes=4 * (2 * 64 + 4 * 8) * 1024,   # 4 CUs x (2 maps banks + 4 WBufs)
    vmem_budget_frac=1.0,
    mxu_dim=16,                    # vMAC width
    sublane=1,
    lane=16,
    ici_bandwidth=0.0,
    ici_links_per_axis=0,
    # Per-tile capacities are PER CU (a maps tile lives in one CU's
    # double-banked 64 KB MBuf; its 4 vMACs hold the kernel tile in
    # 4 x 8 KB WBufs).  The x2 double-buffer accounting in the tiler
    # consumes the second bank / half the WBuf.
    maps_buffer_bytes=2 * 64 * 1024,
    weights_buffer_bytes=4 * 8 * 1024,
    load_units=4,                  # the paper's 4 load/store units
    epilogue_slot_flops=2.0,
    random_buffer_access=False,    # contiguous single-burst DMA only:
                                   # halo strips must be materialized
)


# --- Mesh descriptors ---------------------------------------------------------
@dataclass(frozen=True)
class MeshDescriptor:
    """Static description of a device mesh (no jax device state touched).

    Axis meaning follows launch/mesh.py: ``data`` carries batch (DP/FSDP),
    ``model`` carries tensor/expert parallelism, ``pod`` is the inter-pod
    axis (pipeline or extra data parallelism).
    """

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]

    @property
    def data(self) -> int:
        return self.axis_size("data") * self.axis_size("pod")

    @property
    def model(self) -> int:
        return self.axis_size("model")


SINGLE_POD = MeshDescriptor(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshDescriptor(shape=(2, 16, 16), axes=("pod", "data", "model"))
