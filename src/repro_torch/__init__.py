"""PyTorch/CUDA port of the object-sharing caching system.

A package beside the JAX reference ``repro`` that mirrors its subpackage
and module names, so that each module's counterpart is found under the
same path. It imports ``torch`` and never ``jax`` or ``repro``: host-only
modules are carried as copies, and every kernel that the reference wrote
for a TPU is a CUDA kernel for Hopper (``sm_90a``) under
``repro_torch/kernels/csrc``.

Ported so far, the serving data plane:

* :mod:`repro_torch.configs` — the architecture registry (copy);
* :mod:`repro_torch.core` — ``shared_lru``, ``irm`` and ``admission``
  (copies) and the working-set solver ``workingset`` (torch);
* :mod:`repro_torch.cacheblocks` — the paged KV :class:`BlockPool` on the
  device and the tenant-facing ``SharedPrefixCache``;
* :mod:`repro_torch.kernels` — paged decode attention and shared-prefix
  attention as CUDA kernels, their plain PyTorch versions, and ``ops``;
* :mod:`repro_torch.serving` — the ``ServingEngine`` in accounting mode.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
"""

from .device import resolve_device  # noqa: F401
