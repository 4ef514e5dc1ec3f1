"""The two sides of ``tests/test_torch_launch_dist.py``, each run as a
script in a process of its own.

    python tests/torch_launch_ranks.py reference DIR
        JAX on 2 forced host devices: writes DIR/reference.pkl, the
        inputs (numpy, from seeds), the reference's parameters and what
        its ``make_decode_attention`` and ``make_moe_apply_ep`` programs
        give on the meshes (1, 2) and (2, 1) of (data, model), and its
        decode attention on (pod, data, model) = (1, 2, 1).
    python tests/torch_launch_ranks.py port DIR
        Reads DIR/reference.pkl and runs the same cases through the port
        on 2 gloo ranks (a ``file://`` store in DIR, one torch thread
        each); each rank writes DIR/port_<rank>.pkl.
    python tests/torch_launch_ranks.py reference DIR split
    python tests/torch_launch_ranks.py port DIR split
        The KV cache held split over the model ranks, mesh (data=1,
        model=2): the reference prefills ``PROMPT`` tokens into ``CACHE``
        slots, places its attention caches ``P(None, "model", None,
        None)`` and takes ``SPLIT_STEPS`` decode steps with its
        flash-decode override (DIR/reference_split.pkl: parameters,
        tokens, logits; for recurrentgemma also with its RG-LRU states
        split on their last dim over "model"); the port takes the same
        steps on caches that its prefill writes split (and on caches placed
        by ``reshard_state``, the recurrent states split too, whole caches
        with and without the override, and a split cache without it); each
        rank writes DIR/port_split_<rank>.pkl.

The pickles are written and read by these two functions only.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np

MESHES = ((1, 2), (2, 1))
AXES = ("data", "model")
# two data axes: the batch split over (pod, data) taken together
POD_MESH, POD_AXES = (1, 2, 1), ("pod", "data", "model")
# decode attention: (B, H, KV, D, Dv, S); one row's valid length <= S/2,
# so that the second model rank sees no valid slot for it
ATTN_CASES = {"gqa": (4, 4, 2, 16, 16, 16), "mqa_latent": (4, 4, 1, 24, 16, 16)}
VALID = np.array([3, 8, 16, 11], np.int32)
# the attention shapes each override must decline: T != 1, S % msz != 0
# (on (1, 2)), B % dsz != 0 (on (2, 1))
DECLINE = {"two_tokens": (4, 2, 16), "odd_slots": (4, 1, 15), "odd_batch": (3, 1, 16)}
MODELS = {"qwen3-1.7b": {"n_kv_heads": 2}, "deepseek-v2-236b": {}, "recurrentgemma-2b": {}}
PROMPT, CACHE = 5, 16          # prefill 5 tokens into 16 slots, then one decode step
# the split cache: decode steps from PROMPT until the position passes
# the rank boundary at CACHE / 2
SPLIT_STEPS = 5
SLOT_LEAVES = ("k", "v", "c_kv", "k_rope")
# a recurrent state split over "model" (on its last dim): recurrentgemma's
# RG-LRU h and conv inputs, decoded on the split caches
REC_MODEL, REC_LEAVES = "recurrentgemma-2b", ("h", "conv")
MOE_MODELS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
MOE_B, MOE_T = 2, 8
NO_DROP_CF = 8.0               # capacity k N_loc cf / E >= N_loc: nothing drops


def _attn_inputs(name):
    B, H, KV, D, Dv, S = ATTN_CASES[name]
    rng = np.random.default_rng(len(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return f(B, 1, H, D), f(B, S, KV, D), f(B, S, KV, Dv), VALID[:B], 1.0 / np.sqrt(D)


def _decline_inputs(name):
    B, T, S = DECLINE[name]
    z = np.zeros
    return (z((B, T, 4, 16), np.float32), z((B, S, 2, 16), np.float32),
            z((B, S, 2, 16), np.float32), np.ones((B,), np.int32), 0.25)


def _moe_x(d):
    return np.random.default_rng(7).standard_normal((MOE_B, MOE_T, d)).astype(np.float32)


def _tokens(vocab):
    rng = np.random.default_rng(3)
    return rng.integers(0, vocab, (2, PROMPT + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference (JAX)
# ---------------------------------------------------------------------------
def reference(out_dir: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.flash_decode import make_decode_attention
    from repro.launch.mesh import make_mesh
    from repro.launch.moe_ep import make_moe_apply_ep
    from repro.models import make_model, moe, shardctx

    # every program jitted: the eager shard_map dispatch is many times slower
    res = {"attn": {}, "decline": {}, "models": {}, "moe": {}}
    for shape in MESHES:
        mesh = make_mesh(shape, AXES)
        ov = make_decode_attention(mesh)
        for name in ATTN_CASES:
            q, k, v, valid, scale = _attn_inputs(name)
            fn = jax.jit(lambda q, k, v, vl, scale=scale: ov(q, k, v, vl, scale))
            res["attn"][shape, name] = np.asarray(fn(q, k, v, valid))
        for name in DECLINE:
            q, k, v, valid, scale = _decline_inputs(name)
            res["decline"][shape, name] = jax.eval_shape(
                lambda q, k, v, vl, scale=scale: ov(q, k, v, vl, scale), q, k, v, valid) is None
        for name in MOE_MODELS:
            cfg = get_config(name).reduced()
            p = moe.moe_init(jax.random.PRNGKey(1), cfg)
            ep = make_moe_apply_ep(mesh, cfg)

            def loss(x, w, p=p, ep=ep, cfg=cfg):
                out, aux = ep(x, {**p, **w}, cfg)
                return jnp.sum(out ** 2) + aux, (out, aux)

            w = {n: p[n] for n in ("router", "w_gate", "w_up", "w_down")}
            (_, (out, aux)), (gx, gw) = jax.jit(
                jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(_moe_x(cfg.d_model), w)
            res["moe"][shape, name] = dict(
                params=jax.tree.map(np.asarray, p), out=np.asarray(out), aux=float(aux),
                grad_x=np.asarray(gx), grad_w=jax.tree.map(np.asarray, gw))
    ov = make_decode_attention(make_mesh(POD_MESH, POD_AXES))
    for name in ATTN_CASES:
        q, k, v, valid, scale = _attn_inputs(name)
        fn = jax.jit(lambda q, k, v, vl, scale=scale: ov(q, k, v, vl, scale))
        res["attn"][POD_MESH, name] = np.asarray(fn(q, k, v, valid))
    mesh = make_mesh((1, 2), AXES)
    ov = make_decode_attention(mesh)
    for name, kw in MODELS.items():
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        model = make_model(cfg, compute_dtype=jnp.float32)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        toks = _tokens(cfg.vocab_size)

        def step(params, toks, model=model):
            _, caches = model.prefill(params, {"tokens": toks[:, :PROMPT]}, CACHE)
            pos = jnp.full((toks.shape[0],), PROMPT, jnp.int32)
            with shardctx.rules({"decode_attention": ov}):
                return model.decode_step(params, toks[:, PROMPT:], caches, pos)[0]

        res["models"][name] = dict(params=jax.tree.map(np.asarray, params),
                                   logits=np.asarray(jax.jit(step)(params, toks)))
    with open(out_dir / "reference.pkl", "wb") as f:
        pickle.dump(res, f)


def _split_tokens(vocab):
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, (2, PROMPT + SPLIT_STEPS)).astype(np.int32)


def reference_split(out_dir: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.flash_decode import make_decode_attention
    from repro.launch.mesh import make_mesh
    from repro.models import make_model, shardctx

    mesh = make_mesh((1, 2), AXES)
    ov = make_decode_attention(mesh)

    def place(path, c):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] not in SLOT_LEAVES:
            return c
        lead = 1 if keys[0] == "blocks" else 0
        spec = (None,) * lead + (None, "model") + (None,) * (c.ndim - lead - 2)
        return jax.lax.with_sharding_constraint(c, NamedSharding(mesh, P(*spec)))

    res = {}
    for name, kw in MODELS.items():
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        model = make_model(cfg, compute_dtype=jnp.float32)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        toks = _split_tokens(cfg.vocab_size)

        def steps(params, toks, model=model):
            _, caches = model.prefill(params, {"tokens": toks[:, :PROMPT]}, CACHE)
            caches = jax.tree_util.tree_map_with_path(place, caches)
            out = []
            with shardctx.rules({"decode_attention": ov}):
                for i in range(SPLIT_STEPS):
                    pos = jnp.full((toks.shape[0],), PROMPT + i, jnp.int32)
                    logits, caches = model.decode_step(
                        params, toks[:, PROMPT + i:PROMPT + i + 1], caches, pos)
                    out.append(logits)
            return jnp.stack(out)

        res[name] = dict(params=jax.tree.map(np.asarray, params), tokens=toks,
                         logits=np.asarray(jax.jit(steps)(params, toks)))
        if name == REC_MODEL:
            rec = lambda path, c: (jax.lax.with_sharding_constraint(       # noqa: E731
                c, NamedSharding(mesh, P(*(None,) * (c.ndim - 1), "model")))
                if getattr(path[-1], "key", None) in REC_LEAVES else place(path, c))

            def rec_steps(params, toks, model=model, rec=rec):
                _, caches = model.prefill(params, {"tokens": toks[:, :PROMPT]}, CACHE)
                caches = jax.tree_util.tree_map_with_path(rec, caches)
                out = []
                with shardctx.rules({"decode_attention": ov}):
                    for i in range(SPLIT_STEPS):
                        pos = jnp.full((toks.shape[0],), PROMPT + i, jnp.int32)
                        logits, caches = model.decode_step(
                            params, toks[:, PROMPT + i:PROMPT + i + 1], caches, pos)
                        caches = jax.tree_util.tree_map_with_path(rec, caches)
                        out.append(logits)
                return jnp.stack(out)

            res[name]["rec_logits"] = np.asarray(jax.jit(rec_steps)(params, toks))
    with open(out_dir / "reference_split.pkl", "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the port (torch.distributed, gloo)
# ---------------------------------------------------------------------------
def _port_rank(rank: int, world: int, out_dir: str, split: bool = False) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank)
    try:
        tag = "_split" if split else ""
        with open(Path(out_dir) / f"reference{tag}.pkl", "rb") as f:
            ref = pickle.load(f)
        res = (_port_split if split else _port_cases)(ref)
        with open(Path(out_dir) / f"port{tag}_{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    # the rank's work is done and written: leave without the interpreter's
    # teardown, in which gloo's threads have been seen to abort once under
    # a loaded machine after the group was destroyed
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _port_cases(ref) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import moe_ep
    from repro_torch.launch.flash_decode import make_decode_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_jax_params, make_model, moe, shardctx

    t = torch.from_numpy
    res = {"attn": {}, "decline": {}, "models": {}, "moe": {}, "no_drop": {}}
    for shape in MESHES:
        mesh = make_mesh(shape, AXES, device="cpu")
        ov = make_decode_attention(mesh)
        for name in ATTN_CASES:
            q, k, v, valid, scale = _attn_inputs(name)
            res["attn"][shape, name] = ov(t(q), t(k), t(v), t(valid), scale).numpy()
        for name in DECLINE:
            q, k, v, valid, scale = _decline_inputs(name)
            res["decline"][shape, name] = ov(t(q), t(k), t(v), t(valid), scale) is None
        # on (2, 1) the port also splits f over the data axis (the
        # reference does so only for E d f >= 64 Mi values): the same
        # function through the data group's all-gather
        split = shape == (2, 1)
        old = moe_ep.F_SPLIT_VALUES
        moe_ep.F_SPLIT_VALUES = 0 if split else old
        try:
            for name in MOE_MODELS:
                cfg = get_config(name).reduced()
                r = ref["moe"][shape, name]
                p = {n: t(a) for n, a in r["params"].items() if n != "shared"}
                if "shared" in r["params"]:
                    p["shared"] = {n: t(a) for n, a in r["params"]["shared"].items()}
                w = {n: p[n].clone().requires_grad_(True)
                     for n in ("router", "w_gate", "w_up", "w_down")}
                x = t(_moe_x(cfg.d_model)).requires_grad_(True)
                ep = moe_ep.make_moe_apply_ep(mesh, cfg)
                out, aux = ep(x, {**p, **w}, cfg)
                (out.square().sum() + aux).backward()
                res["moe"][shape, name] = dict(
                    out=out.detach().numpy(), aux=float(aux.detach()), grad_x=x.grad.numpy(),
                    grad_w={n: a.grad.numpy() for n, a in w.items()}, split=split)
                # where nothing drops, EP is the single-device drop-free MoE
                big = dataclasses.replace(cfg, capacity_factor=NO_DROP_CF)
                with torch.no_grad():
                    got, _ = moe_ep.make_moe_apply_ep(mesh, big)(x, p, big)
                    want, _ = moe.moe_apply(x, p, big, no_drop=True)
                res["no_drop"][shape, name] = float((got - want).abs().max())
        finally:
            moe_ep.F_SPLIT_VALUES = old
    ov = make_decode_attention(make_mesh(POD_MESH, POD_AXES, device="cpu"))
    for name in ATTN_CASES:
        q, k, v, valid, scale = _attn_inputs(name)
        res["attn"][POD_MESH, name] = ov(t(q), t(k), t(v), t(valid), scale).numpy()
    ov = make_decode_attention(make_mesh((1, 2), AXES, device="cpu"))
    for name, kw in MODELS.items():
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        model = make_model(cfg, compute_dtype=torch.float32)
        params = from_jax_params(ref["models"][name]["params"], cfg, device="cpu")
        toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
        with torch.no_grad():
            _, caches = model.prefill(params, {"tokens": toks[:, :PROMPT]}, CACHE)
            pos = torch.full((2,), PROMPT, dtype=torch.int32)
            with shardctx.rules({"decode_attention": ov}):
                logits, _ = model.decode_step(params, toks[:, PROMPT:], caches, pos)
        res["models"][name] = logits.numpy()
    return res


def _port_split(ref) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.flash_decode import SplitCaches, make_decode_attention
    from repro_torch.launch.mesh import Sharding, make_mesh
    from repro_torch.models import from_jax_params, make_model, shardctx
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, leaves, tree_map, unflatten

    mesh = make_mesh((1, 2), AXES, device="cpu")
    ov, sc = make_decode_attention(mesh), SplitCaches(mesh)
    split_rules = {"decode_attention": ov, "cache_split": sc}
    local = lambda caches: {p: (x.to_local() if hasattr(x, "to_local") else x)  # noqa: E731
                            .numpy().copy() for p, x in flatten_with_paths(caches)}
    res = {}
    for name, kw in MODELS.items():
        cfg = dataclasses.replace(get_config(name).reduced(), **kw)
        model = make_model(cfg, compute_dtype=torch.float32)
        params = from_jax_params(ref[name]["params"], cfg, device="cpu")
        toks = torch.from_numpy(ref[name]["tokens"]).long()
        B = toks.shape[0]

        def decode(caches, rules):
            out = []
            with shardctx.rules(rules):
                for i in range(SPLIT_STEPS):
                    pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
                    logits, caches = model.decode_step(params, toks[:, PROMPT + i:PROMPT + i + 1],
                                                       caches, pos)
                    out.append(logits)
            return torch.stack(out).numpy(), caches

        r = {}
        with torch.no_grad():
            prompt = {"tokens": toks[:, :PROMPT]}
            # the caches written split by prefill (the "cache_split" rule)
            with shardctx.rules({"cache_split": sc}):
                _, split = model.prefill(params, prompt, CACHE)
                # zeroed caches allocated split
                zeros = model.init_cache(B, CACHE, device="cpu")
            r["prefill_local"] = local(split)
            r["placements"] = {p: str(tuple(x.placements)) for p, x in flatten_with_paths(split)}
            r["logits"], split = decode(split, split_rules)
            r["local"] = local(split)
            r["init_shapes"] = {p: tuple(x.to_local().shape) for p, x in
                                flatten_with_paths(zeros)}
            # whole caches placed by reshard_state, the reference's way
            _, whole = model.prefill(params, prompt, CACHE)
            placed = reshard_state(tree_map(torch.clone, whole), sc.shardings(model, B, CACHE))
            r["reshard_logits"], _ = decode(placed, split_rules)
            if name == REC_MODEL:
                # the recurrent states split on their last dim over "model":
                # gathered whole for each step, each rank keeping its block
                specs = sc.shardings(model, B, CACHE)
                specs = unflatten(specs, [
                    Sharding(mesh, (None,) * (len(x.shape) - 1) + ("model",))
                    if p.endswith(tuple(f"[{n!r}]" for n in REC_LEAVES)) else sh
                    for (p, x), sh in zip(flatten_with_paths(whole), leaves(specs))])
                rec = reshard_state(tree_map(torch.clone, whole), specs)
                r["rec_logits"], rec = decode(rec, split_rules)
                r["rec_local"] = local(rec)
                r["rec_placements"] = {p: str(tuple(x.placements))
                                       for p, x in flatten_with_paths(rec)}
            # whole caches on every rank, with the override (each rank reads
            # its slots) and without it (one device's decode)
            r["whole_logits"], w = decode(tree_map(torch.clone, whole), {"decode_attention": ov})
            r["whole"] = local(w)
            r["plain_logits"], w = decode(whole, {})
            r["plain"] = local(w)
            # a split cache without the override
            with shardctx.rules({"cache_split": sc}):
                _, split = model.prefill(params, prompt, CACHE)
            try:
                decode(split, {"cache_split": sc})
                r["no_override"] = None
            except ValueError as e:
                r["no_override"] = str(e)
        res[name] = r
    return res


def port(out_dir: Path, world: int = 2, timeout: float = 150.0, split: bool = False) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank, args=(r, world, str(out_dir), split))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise SystemExit(f"port ranks exited with {codes}")


if __name__ == "__main__":
    mode, out = sys.argv[1], Path(sys.argv[2])
    split = sys.argv[3:] == ["split"]
    if mode == "reference":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        (reference_split if split else reference)(out)
    else:
        port(out, split=split)
