"""The architectures of the configuration files, one module each.

A configuration file names its module under ``"arch"`` by its import
name (``"chipbench.archs.<name>"``); a file without the key is
:mod:`chipbench.archs.gqa`. A module gives, for a configuration ``c``
(the parsed file):

* ``leaf_specs(c)``: (path, shape, std) of every leaf of the port's
  parameter tree, in the order they are drawn; ``keeps_f32(path)``: the
  leaves the port keeps in f32; ``leaves(c, seed, device, dtype, rank=0,
  world=1)``: (path, leaf) in that order, drawn from the seed on
  ``device``. Each rank draws its own share of a sharded leaf; a leaf
  whose draw does not depend on the rank is the same on every rank.
* ``arch_config(c)``: the port's ``ArchConfig`` of the file;
  ``make_model(c, ranks, **kw)``: the port's model of it on this rank
  (``kw``: dtypes, remat), with whatever the architecture installs
  around it (an override of a layer on the ranks' group);
  ``make_train_step(model, config, ranks)``: the port's train step of it.
* ``param_counts(c)``, ``train_step_flops(c, B, T)``,
  ``prefill_flops(c, T)``: the model's work, counted from its shapes.
* ``attention_work(c, B, T, lse)``: {"k3": (bytes, flops), "k3bwd":
  (bytes, flops)} of one K3 launch and one K3-bwd call at the true
  widths, which ``k3_bound_ms`` and ``k3bwd_bound_ms`` are made of.
* ``bytes_per_block(c, block_tokens)``: the cache bytes of one block.
* ``cache_rows(caches, lo, n)``: the cache rows ``lo .. lo + n - 1`` of
  the first sequence of every layer, from the caches a prefill or decode
  step hands back, as a tuple of tensors (layers, n, ...).
* ``reference``: the plain reference module, with ``loss(params, c,
  batch, quant=None)`` and ``logits_at(params, c, tokens, positions,
  quant=None, kv=False)``; with ``kv`` it returns (logits, *rows), rows
  shaped and ordered as ``cache_rows``'.
* ``SPLIT_WORK``: whether the ranks of a cell with more than one chip do
  different work (their work counters are summed) or the same (rank 0's
  are taken).
"""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "chipbench.archs.gqa"


def of(c: dict) -> ModuleType:
    """The architecture module that configuration ``c`` names."""
    return importlib.import_module(c.get("arch", DEFAULT))
