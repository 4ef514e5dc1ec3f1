"""prefix_hit_token_ratio.serve: the window's prompt tokens found in the
shared prefix cache (the engine's ``cached_tokens``) over all its prompt
tokens, %."""


def read(rec):
    if rec.kind != "serve" or not rec.counters.get("prompt_tokens"):
        return None
    return 100.0 * rec.counters["cached_tokens"] / rec.counters["prompt_tokens"]
