"""Kernels of the serving data plane, of model prefill and of the
estimator loop.

* :mod:`~repro_torch.kernels.ops` — the public entry points;
* :mod:`~repro_torch.kernels.paged_attention` (K1),
  :mod:`~repro_torch.kernels.shared_prefix_attention` (K2) and
  :mod:`~repro_torch.kernels.flash_attention` (K3) — each a CUDA
  kernel for Hopper (``csrc/*.cu``), its wrapper with a launch count, and
  its plain PyTorch version;
* :mod:`~repro_torch.kernels.lane_engine` — the estimator loop's lane
  engine (not a Pallas kernel: the reference's XLA program
  ``core/fastsim_jax.py``), a CUDA kernel with one thread per lane and
  the same step built by g++ as its plain version;
* :mod:`~repro_torch.kernels.ref` — the plain PyTorch oracles;
* :mod:`~repro_torch.kernels._build` — builds ``csrc/`` with ``nvcc``
  (and a kernel's host translation unit with g++).
"""
