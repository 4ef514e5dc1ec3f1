"""The paper's object-sharing caching system: the modules of the serving
data plane and of the estimator loop.

* :mod:`~repro_torch.core.shared_lru` — Section III: J LRU-lists over one
  physical cache with per-object length apportionment and the
  ripple-eviction operator loop (host copy; the executable spec).
* :mod:`~repro_torch.core.slru` — Section VII: Segmented-LRU (host copy).
* :mod:`~repro_torch.core.fastsim` — the array-based Monte-Carlo engine
  and its host drivers (Python loops; the C loop of
  :mod:`~repro_torch.core.fastsim_c`), host copies; ``engine="cuda"``
  drives :mod:`~repro_torch.core.fastsim_cuda`, the lane engine on the
  card (one CUDA thread per replica).
* :mod:`~repro_torch.core.baselines`, :mod:`~repro_torch.core.metrics` —
  not-shared / pooled baselines and recorders (host copies).
* :mod:`~repro_torch.core.cluster` — the K-node consistent-hash cluster
  on the host engines (host copy).
* :mod:`~repro_torch.core.irm` — IRM/Zipf traces and popularity
  estimation (host copy).
* :mod:`~repro_torch.core.workingset` — Section IV: working-set
  approximation of hit probabilities (torch fixed-point solver;
  L1/Lstar/L2/full; one allocation vector or a batch of them).
* :mod:`~repro_torch.core.admission` — Section IV-C: overbooking +
  admission (host copy over the torch solver).
"""

from .shared_lru import (  # noqa: F401
    EvictionEvent,
    GetResult,
    RequestStats,
    SharedLRUCache,
)
from .slru import SegmentedSharedLRUCache  # noqa: F401
from .fastsim import (  # noqa: F401
    FastSegmentedSharedLRU,
    FastSharedLRU,
    SimParams,
    SimResult,
    SparseOccupancy,
    simulate_chunks,
    simulate_trace,
)
from .baselines import NotSharedSystem, PooledLRU, SimpleLRU  # noqa: F401
from .irm import (  # noqa: F401
    IRMTrace,
    PopularityEstimator,
    rate_matrix,
    sample_trace,
    sample_trace_chunks,
    zipf_popularities,
)
from .workingset import (  # noqa: F401
    WorkingSetSolution,
    attribution_matrix,
    expected_inverse_one_plus,
    hit_probabilities,
    solve_workingset,
    solve_workingset_batch,
    solve_workingset_unshared,
    virtual_footprint,
)
from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    Tenant,
    virtual_allocations,
)
from .cluster import (  # noqa: F401
    FaultEvent,
    FaultSpec,
    HashRing,
    default_ring,
    key_position,
    key_positions,
    simulate_cluster,
)
from .metrics import HitRecorder, LatencyRecorder, RippleStats, table_rows  # noqa: F401
