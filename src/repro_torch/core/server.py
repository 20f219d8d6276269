"""Physical-server models (paper Table I).

The paper's testbed (Table I):

  M1: Core i7 @2.00GHz,      LLC 6MB, mem 8GB, system file cache 980MB, disk cache 12MB
  M2: Core2 Duo @3.00GHz,    LLC 6MB, mem 3GB, system file cache 455MB, disk cache  8MB

Beyond the raw Table-I numbers, the simulator needs per-level performance
constants (bandwidths + per-request overheads). These are *calibration*
constants chosen so the simulator reproduces the paper's qualitative and
quantitative claims:

  * three throughput levels for write / two for read (§III.C, Fig 1-2);
  * throughput monotonically increasing in RS (disk-overhead amortization);
  * losing LLC costs >50% throughput for RS > 8KB (§V, Fig 6);
  * the *actual* TDP sits at ~7.76MB vs the 6MB LLC, i.e. the physical
    cache tolerates ~1.29x oversubscription -> the paper calibrates α≈1.3.
"""
from __future__ import annotations

import dataclasses

from .units import GB, KB, MB, MS, US


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """A physical server as seen by the consolidation model (one 2-D bin)."""

    name: str
    llc_bytes: float  # last-level cache (the paper's hard contention resource)
    mem_bytes: float
    file_cache_bytes: float  # OS system-file-cache
    disk_cache_bytes: float  # drive-embedded cache
    cores: int
    ghz: float

    # --- per-level performance constants (simulator calibration) ---------
    # level 1: working set fits LLC;  level 2: fits file-cache + disk-cache;
    # level 3 (write only): spills to actual disk.
    bw_l1_read: float = 6.2 * GB
    bw_l2_read: float = 2.2 * GB
    bw_l1_write: float = 5.1 * GB
    bw_l2_write: float = 1.8 * GB
    bw_l3_write: float = 115 * MB  # actual disk write speed
    ov_l12: float = 1.2 * US  # per-request overhead at cache levels
    ov_l3: float = 7.0 * MS  # seek + rotational + controller at disk level

    # shared-resource capacities for co-run contention (§IV.B)
    shared_bw: float = 3.2 * GB  # storage-subsystem aggregate bandwidth
    cpu_req_cost: float = 2.5 * US  # CPU time per file operation
    cpu_byte_cost: float = 0.08e-9  # CPU time per byte moved

    # physical LLC over-subscription tolerance: actual TDP / LLC size.
    # The paper measures actual TDPs at ~7.76MB against a 6MB LLC -> ~1.29.
    # (This is a property of the *hardware*; α in Eqn (5) is the scheduler's
    # estimate of it, swept in Fig 9.)
    llc_tolerance: float = 7.76 / 6.0

    @property
    def cache_spill_bytes(self) -> float:
        """Capacity of the level-2 tier (file cache + disk cache), §III.C."""
        return self.file_cache_bytes + self.disk_cache_bytes


# --- Paper Table I ------------------------------------------------------------
M1 = ServerSpec(
    name="M1",
    llc_bytes=6 * MB,
    mem_bytes=8 * GB,
    file_cache_bytes=980 * MB,
    disk_cache_bytes=12 * MB,
    cores=4,
    ghz=2.0,
)

# M2 is older/smaller: scale the cache-level bandwidths down, disk similar.
M2 = ServerSpec(
    name="M2",
    llc_bytes=6 * MB,
    mem_bytes=3 * GB,
    file_cache_bytes=455 * MB,
    disk_cache_bytes=8 * MB,
    cores=2,
    ghz=3.0,
    bw_l1_read=4.6 * GB,
    bw_l2_read=1.7 * GB,
    bw_l1_write=3.9 * GB,
    bw_l2_write=1.4 * GB,
    bw_l3_write=95 * MB,
    shared_bw=2.4 * GB,
)

#: The paper's evaluation cluster (§VIII): 2x M1 + 2x M2.
PAPER_CLUSTER = (M1, dataclasses.replace(M1, name="M1b"), M2, dataclasses.replace(M2, name="M2b"))


# --- accelerator hosts as consolidation bins (DESIGN.md §2) -------------------
# A TPU v5e host: 8 chips, 16GB HBM each. The consolidation "cache" dimension
# becomes the HBM byte budget; the shared bandwidth becomes aggregate HBM bw.
# (A copy of the JAX package's spec, so both admit request streams alike.)
TPU_V5E_HOST = ServerSpec(
    name="tpu-v5e-host",
    llc_bytes=8 * 16 * GB,  # HBM capacity = the hard contention resource
    mem_bytes=512 * GB,  # host DRAM
    file_cache_bytes=256 * GB,  # host staging buffers (input pipeline)
    disk_cache_bytes=4 * GB,
    cores=224,
    ghz=2.0,
    shared_bw=8 * 819 * GB,  # aggregate HBM bandwidth
    llc_tolerance=1.0,  # HBM does not over-subscribe: OOM is a cliff
)

# One v5e pod-slice of 256 chips treated as a single consolidation bin
# (the JAX package's core/cluster.py packs whole jobs onto pod slices).
TPU_V5E_POD256 = ServerSpec(
    name="tpu-v5e-pod256",
    llc_bytes=256 * 16 * GB,
    mem_bytes=32 * 512 * GB,
    file_cache_bytes=32 * 256 * GB,
    disk_cache_bytes=128 * GB,
    cores=32 * 224,
    ghz=2.0,
    shared_bw=256 * 819 * GB,
    llc_tolerance=1.0,
)

# An 8-GPU H100 SXM host (NVIDIA DGX H100 data sheet: 8 x 80 GB HBM3 at
# 3.35 TB/s each, 2 TB of system memory, two 56-core Xeon 8480C at 2.0 GHz),
# mapped as the TPU host is: HBM capacity is the budget, aggregate HBM
# bandwidth the shared pipe, and HBM does not over-subscribe.
H100_HOST = ServerSpec(
    name="h100-host",
    llc_bytes=8 * 80 * GB,
    mem_bytes=2048 * GB,
    file_cache_bytes=1024 * GB,
    disk_cache_bytes=4 * GB,
    cores=112,
    ghz=2.0,
    shared_bw=8 * 3.35e12,
    llc_tolerance=1.0,
)
