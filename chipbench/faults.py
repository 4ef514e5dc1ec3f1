"""Faults planted under a run's timed path, for the checks that must see
them (the CPU tests, and ``calibrate.py --fault`` on the card). A train
fault wraps the train step (the drivers' ``hooks["step"]``), a serve
fault the model the engine is handed (``hooks["model"]``)."""

import copy


def state_unchanged(step):
    """The step computes on a copy and hands back the state it was given."""
    def fault(state, batch):
        _, metrics = step(copy.deepcopy(state), batch)
        return state, metrics
    return fault


def half_batch(step):
    """Half the batch left out; the mean taken over the rest."""
    def fault(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return fault


class _Wrapped:
    def __init__(self, model):
        self.model = model

    def prefill(self, params, batch, cache_len):
        return self.model.prefill(params, batch, cache_len)


class AlteredToken(_Wrapped):
    """Each decode step's logits shifted by one id: its token is altered
    where it is produced."""

    def decode_step(self, params, tokens, caches, position):
        logits, caches = self.model.decode_step(params, tokens, caches, position)
        return logits.roll(1, dims=-1), caches


class CacheUnchanged(_Wrapped):
    """Each decode step computes on a copy of the caches: they come back as
    they were, without the step's key and value rows."""

    def decode_step(self, params, tokens, caches, position):
        logits, _ = self.model.decode_step(params, tokens, copy.deepcopy(caches), position)
        return logits, caches


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SERVE = {"altered_token": AlteredToken, "cache_unchanged": CacheUnchanged}
