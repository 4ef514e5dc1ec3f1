"""Serving launcher: the multi-tenant engine with the object-sharing
prefix cache over a reduced model (the reference's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 60 --tenants 3 --overlap 0.7 [--live] [--device cpu]

``--device`` defaults to the card (none there: it raises; name ``cpu`` to
run the plain PyTorch path). The prompts are drawn from
``np.random.default_rng(--seed)`` in the reference's order, so both
launchers serve the same request stream; ``--live`` draws the reduced
model's parameters with a ``torch.Generator`` seeded from ``--seed``, in
f32 as the reference does.

After the engine's stats it prints the requests' spans and counters
(:mod:`repro_torch.tracing`): each span's count and its mean and p90 ms a
request, and each counter's total a request.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--overlap", type=float, default=0.7,
                    help="probability a request uses a shared prompt")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode", type=int, default=4)
    ap.add_argument("--live", action="store_true",
                    help="decode with a real reduced model (slower)")
    ap.add_argument("--rre-slack", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import tracing
    from repro_torch.cacheblocks import layout_for
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    cfg = get_config(args.arch).reduced()
    ecfg = EngineConfig(block_tokens=8, pool_blocks=1024, rre_slack=args.rre_slack)
    layout = layout_for(cfg, block_tokens=8)
    pool_bytes = ecfg.pool_blocks * layout.bytes_per_block
    model = params = None
    if args.live:
        from repro_torch.models import make_model

        model = make_model(cfg, compute_dtype=torch.float32)
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    share = 0.9 / args.tenants
    engine = ServingEngine(
        cfg,
        [TenantSpec(f"t{i}", share * pool_bytes) for i in range(args.tenants)],
        ecfg, model=model, params=params, device=device,
    )
    shared_prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len) for _ in range(8)]
    for i in range(args.requests):
        t = f"t{rng.integers(args.tenants)}"
        if rng.random() < args.overlap:
            prompt = shared_prompts[rng.integers(len(shared_prompts))]
        else:
            prompt = rng.integers(0, cfg.vocab_size, args.prompt_len)
        user = rng.integers(0, cfg.vocab_size, 16)
        engine.submit(t, np.concatenate([prompt, user]),
                      max_new_tokens=args.decode if args.live else 0)
    print("engine stats:")
    for k, v in engine.stats().items():
        print(f"  {k}: {v:.4g}" if isinstance(v, float) else f"  {k}: {v}")
    print_request_spans(tracing.records(args.requests))
    return 0


def print_request_spans(records) -> None:
    """Each span's count and its mean and p90 ms a request (a request's
    spans of one name summed), then each counter's total a request."""
    if not records:
        return
    print(f"request spans ({len(records)} requests; count, mean ms, p90 ms):")
    for name in sorted({n for r in records for n in r.spans}):
        ms = [1e3 * r.seconds(name) for r in records]
        n = sum(len(r.spans.get(name, ())) for r in records)
        print(f"  {name}: {n}, {np.mean(ms):.4g}, {np.percentile(ms, 90):.4g}")
    print("request counters (total a request):")
    for name in sorted({n for r in records for n in r.counts}):
        print(f"  {name}: {sum(r.counts.get(name, 0) for r in records) / len(records):.4g}")


if __name__ == "__main__":
    sys.exit(main())
