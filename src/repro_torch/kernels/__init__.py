"""Attention kernels of the serving data plane and of model prefill.

* :mod:`~repro_torch.kernels.ops` — the public entry points;
* :mod:`~repro_torch.kernels.paged_attention` (K1),
  :mod:`~repro_torch.kernels.shared_prefix_attention` (K2) and
  :mod:`~repro_torch.kernels.flash_attention` (K3) — each a CUDA
  kernel for Hopper (``csrc/*.cu``), its wrapper with a launch count, and
  its plain PyTorch version;
* :mod:`~repro_torch.kernels.ref` — the plain PyTorch oracles;
* :mod:`~repro_torch.kernels._build` — builds ``csrc/`` with ``nvcc``.
"""
