"""k3bwd_roofline.train: K3-bwd's calls in the profiled steps (each its
three kernels: delta, dK/dV, dQ) at their bound over their device time, %."""

from chipbench.harness.profiling import K3BWD_CALL_KERNEL


def read(rec):
    if rec.profile is None or rec.kind != "train":
        return None
    sec, _, ks = rec.profile.group("K3-bwd", "step")
    calls = sum(n for k, (_, n) in ks.items() if K3BWD_CALL_KERNEL in k)
    return 100.0 * calls * rec.work["k3bwd_bound_ms"] * 1e-3 / sec if calls and sec > 0 else None
