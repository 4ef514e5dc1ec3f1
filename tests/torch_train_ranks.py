"""The two sides of ``tests/test_torch_train_dist.py``, each run as a
script in a process of its own.

    python tests/torch_train_ranks.py reference DIR
        JAX on 2 forced host devices, mesh (data=2, model=1): writes
        DIR/reference.pkl, the reduced models' parameters, each device's
        shard of a state placed by ``reshard_state`` (one spec for every
        leaf, and a tree of specs), and ``jax.jit`` of ``make_train_step``
        over two steps with the state replicated and the batch on
        P("data"): the losses and the final states.
    python tests/torch_train_ranks.py port DIR
        Reads DIR/reference.pkl; writes a one-process checkpoint of the
        first case's state (DIR/ckpt1), then runs the port's 2 gloo ranks
        (a ``file://`` store in DIR, one torch thread each): the same
        placements and steps on a (data=2, model=1) mesh, the world-1
        checkpoint restored onto the mesh, and the two-step state saved
        from the mesh (DIR/ckpt2); each rank writes DIR/port_<rank>.pkl.

The pickles are written and read by these two functions only.
"""

from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

import numpy as np

SHAPE, AXES = (2, 1), ("data", "model")
B, T, STEPS = 4, 16, 2
# (name, arch, microbatches, compression, moe_chunks); each two steps
CASES = (("qwen3", "qwen3-1.7b", 1, False, 0),
         ("qwen3_mb2_compress", "qwen3-1.7b", 2, True, 0),
         ("granite_moe_chunks2", "granite-moe-1b-a400m", 1, False, 2))
LR = dict(lr=3e-3, warmup_steps=5, total_steps=100)
COMPRESS_MIN = 256          # the reduced leaves are small: compress most of them


def batches(vocab: int):
    """STEPS batches of B x T tokens, each with a mask that drops other
    positions in each row, so that the ranks' token counts differ."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
        mask = rng.random((B, T)) < np.linspace(0.3, 1.0, B)[:, None]
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask})
    return out


def spec_tree_names(params):
    """"data" for a leaf whose first dim splits over 2, else None (per
    leaf), as a dict path -> name over the parameter paths."""
    return {path: ("data" if np.ndim(a) >= 1 and np.shape(a)[0] % 2 == 0 else None)
            for path, a in params}


# ---------------------------------------------------------------------------
# the reference (JAX)
# ---------------------------------------------------------------------------
def reference(out_dir: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import make_model, shardctx
    from repro.training import AdamWConfig, TrainConfig, make_train_step
    from repro.training.compression import CompressionConfig
    from repro.training.elastic import reshard_state
    from repro.training.train_step import init_train_state

    mesh = make_mesh(SHAPE, AXES)
    flat = lambda tree: [(jax.tree_util.keystr(k), v)                  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    shards = lambda x: [np.asarray(s.data) for s in                    # noqa: E731
                        sorted(x.addressable_shards, key=lambda s: s.device.id)]
    res = {"cases": {}}
    for name, arch, mb, comp, chunks in CASES:
        cfg = get_config(arch).reduced()
        model = make_model(cfg, compute_dtype=jnp.float32)
        tcfg = TrainConfig(optimizer=AdamWConfig(**LR), microbatches=mb,
                           compute_dtype=jnp.float32,
                           compression=CompressionConfig(min_size=COMPRESS_MIN) if comp else None)
        state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
        params = jax.tree.map(np.asarray, state["params"])
        case = {"params": params}
        if name == CASES[0][0]:
            # placements: one spec for every leaf, and one spec a leaf
            one = reshard_state(state["params"], jax.tree.map(
                lambda _: NamedSharding(mesh, P()), state["params"]))
            names = spec_tree_names(flat(params))
            tree = jax.tree_util.tree_map_with_path(
                lambda k, _: NamedSharding(mesh, P(names[jax.tree_util.keystr(k)])), params)
            per_leaf = reshard_state(state["params"], tree)
            res["placed"] = {"replicated": {p: shards(x) for p, x in flat(one)},
                             "per_leaf": {p: shards(x) for p, x in flat(per_leaf)}}
        rep = NamedSharding(mesh, P())
        state = reshard_state(state, jax.tree.map(lambda _: rep, state))
        with shardctx.rules({"moe_chunks": chunks} if chunks else {}):
            step = jax.jit(make_train_step(model, tcfg))
            losses = []
            for b in batches(cfg.vocab_size):
                b = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in b.items()}
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        case.update(losses=losses, state=dict(flat(jax.tree.map(np.asarray, state))))
        res["cases"][name] = case
    with open(out_dir / "reference.pkl", "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the port (torch.distributed, gloo)
# ---------------------------------------------------------------------------
def _setup(ref_case, arch, mb, comp):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import from_jax_params, make_model
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training.compression import CompressionConfig, compression_init
    from repro_torch.training.optimizer import adamw_init

    cfg = get_config(arch).reduced()
    model = make_model(cfg, compute_dtype=torch.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(**LR), microbatches=mb, compute_dtype=torch.float32,
                       compression=CompressionConfig(min_size=COMPRESS_MIN) if comp else None)
    params = from_jax_params(ref_case["params"], cfg, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    if comp:
        state["compress"] = compression_init(params)
    return cfg, model, tcfg, state


def _port_rank(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank)
    try:
        with open(Path(out_dir) / "reference.pkl", "rb") as f:
            ref = pickle.load(f)
        res = _port_cases(ref, Path(out_dir))
        with open(Path(out_dir) / f"port_{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    # the rank's work is written: leave without the interpreter's teardown
    # (see tests/torch_launch_ranks.py)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _port_cases(ref, out_dir: Path) -> dict:
    import torch

    from repro_torch.launch.mesh import Sharding, make_mesh
    from repro_torch.training import make_train_step
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, leaves, tree_map, unflatten

    mesh = make_mesh(SHAPE, AXES, device="cpu")
    rep = Sharding(mesh)
    rows = slice(mesh.get_coordinate()[0] * B // 2, (mesh.get_coordinate()[0] + 1) * B // 2)
    full = lambda tree: {p: x.full_tensor().numpy()                   # noqa: E731
                         for p, x in flatten_with_paths(tree)}
    res = {"cases": {}}
    for name, arch, mb, comp, chunks in CASES:
        cfg, model, tcfg, state = _setup(ref["cases"][name], arch, mb, comp)
        if name == CASES[0][0]:
            params = state["params"]
            names = spec_tree_names([(p, x.numpy()) for p, x in flatten_with_paths(params)])
            specs = unflatten(params, [Sharding(mesh, (names[p],) + (None,) * (x.ndim - 1))
                                       if names[p] else rep
                                       for p, x in flatten_with_paths(params)])
            res["placed"] = {
                kind: {p: x.to_local().numpy() for p, x in
                       flatten_with_paths(reshard_state(tree_map(torch.clone, params), spec))}
                for kind, spec in (("replicated", rep), ("per_leaf", specs))}
            # the world-1 checkpoint restored onto the mesh, a spec a leaf
            ck = Checkpointer(out_dir / "ckpt1")
            back, _ = ck.restore(None, state, {"params": specs, "opt": rep})
            res["restored"] = {p: x.to_local().numpy() for p, x in flatten_with_paths(back)}
        state = reshard_state(state, rep)
        if not all(x.placements[0].is_replicate() for x in leaves(state)):
            raise AssertionError("a leaf is not replicated")
        step = make_train_step(model, tcfg)
        losses, calls = [], []
        for b in batches(cfg.vocab_size):
            state, m = step(state, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
            losses.append(float(m["loss"]))
            calls.append(int(m["collectives"]))
        res["cases"][name] = dict(losses=losses, calls=calls, state=full(state))
        if name == CASES[0][0]:
            Checkpointer(out_dir / "ckpt2").save(STEPS, state, {"step": STEPS})
    return res


def world1_state(ref):
    """The first case's state with moments that are not zero, on the host."""
    import torch

    from repro_torch.training.tree import tree_map

    name, arch, mb, comp, _ = CASES[0]
    state = _setup(ref["cases"][name], arch, mb, comp)[3]
    state["opt"]["mu"] = tree_map(lambda p: 0.5 * p, state["params"])
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    return state


def save_world1(ref, out_dir: Path) -> None:
    from repro_torch.training.checkpoint import Checkpointer

    Checkpointer(out_dir / "ckpt1").save(7, world1_state(ref), {"step": 7})


def port(out_dir: Path, world: int = 2, timeout: float = 150.0) -> None:
    import multiprocessing as mp

    with open(out_dir / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    save_world1(ref, out_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank, args=(r, world, str(out_dir))) for r in range(world)]
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
    if mode == "reference":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        reference(out)
    else:
        port(out)
