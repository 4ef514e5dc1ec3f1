"""The paper's object-sharing caching system: the modules that the
serving data plane needs.

* :mod:`~repro_torch.core.shared_lru` — Section III: J LRU-lists over one
  physical cache with per-object length apportionment and the
  ripple-eviction operator loop (host copy; the executable spec).
* :mod:`~repro_torch.core.irm` — IRM/Zipf traces and popularity
  estimation (host copy).
* :mod:`~repro_torch.core.workingset` — Section IV: working-set
  approximation of hit probabilities (torch fixed-point solver;
  L1/Lstar/L2/full).
* :mod:`~repro_torch.core.admission` — Section IV-C: overbooking +
  admission (host copy over the torch solver).
"""

from .shared_lru import (  # noqa: F401
    EvictionEvent,
    GetResult,
    RequestStats,
    SharedLRUCache,
)
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
    solve_workingset_unshared,
    virtual_footprint,
)
from .admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    Tenant,
    virtual_allocations,
)
