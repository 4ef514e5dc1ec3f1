"""A stand-in architecture module for the tests: the GQA module's
interface, each function counted in ``CALLS`` by name before it calls
the GQA module's (the reference's as ``reference.loss`` and
``reference.logits_at``)."""

from collections import Counter
from types import SimpleNamespace

from chipbench.archs import gqa

CALLS: Counter = Counter()
SPLIT_WORK = gqa.SPLIT_WORK


def _counted(name, fn):
    def call(*args, **kwargs):
        CALLS[name] += 1
        return fn(*args, **kwargs)
    return call


for _name in ("leaf_specs", "keeps_f32", "leaves", "arch_config", "make_model",
              "make_train_step", "param_counts",
              "train_step_flops", "prefill_flops", "attention_work", "bytes_per_block",
              "cache_rows"):
    globals()[_name] = _counted(_name, getattr(gqa, _name))

reference = SimpleNamespace(**{n: _counted(f"reference.{n}", getattr(gqa.reference, n))
                               for n in ("loss", "logits_at")})
