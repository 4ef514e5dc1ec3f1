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
    python tests/torch_train_ranks.py reference DIR placed
    python tests/torch_train_ranks.py port DIR placed
        The same cases on a state placed leaf by leaf (``PLACEMENTS``):
        ZeRO-1 on (data=2, model=1), the moments and residuals split over
        "data", and the parameters with their moments and residuals split
        over "model" on (data=1, model=2); and, for the qwen3 cases, μ and
        ν placed apart on (data=2, model=1) and the "model" placement on a
        mesh of "model" alone, (2,). The reference writes
        DIR/reference_placed.pkl (each device's shards before the steps,
        the losses and final states of ``jax.jit(make_train_step)``, and
        the final states of the same steps on one device); the
        port writes DIR/ckpt1 as above, then each rank
        DIR/port_placed_<rank>.pkl (its shards, losses, collectives by
        kind, the bytes it holds, the final states), the world-1
        checkpoint restored onto the ZeRO-1 placements, and the ZeRO-1
        state after two steps saved from the mesh (DIR/ckpt_zero1).

    python tests/torch_train_ranks.py reference DIR megatron
    python tests/torch_train_ranks.py port DIR megatron
        Partitioned compute over "model" (``megatron_names``: Megatron's
        column/row placement) for the reduced qwen3 with G = 2, on (data=1,
        model=2) and on a mesh of "model" alone: the reference's placed
        ``jax.jit`` steps (and one device's) for two cases, then its
        prefill and greedy decode steps with the caches' K and V placed on
        their heads; and the reduced granite-moe-1b (experts split on their
        expert dim, and on their columns) and deepseek-v2 (MLA on its
        heads, experts on their expert dim) on (data=1, model=2)
        (``MP_MOE_CASES``): two placed steps, the first step's gradient and
        greedy serving (DIR/reference_megatron.pkl); the port's 2 gloo
        ranks the same (DIR/port_megatron_<rank>.pkl: losses, collectives
        by kind, the heads each K3 call got, each rank's gradient, state
        and cache bytes, the final states, the logits and greedy tokens,
        the MoE routings against a plain forward's; qwen3's decode also on
        K/V placed on their slots).
    python tests/torch_train_ranks.py reference DIR vocab
    python tests/torch_train_ranks.py port DIR vocab
        The embedding and the head split on their vocabulary too
        (``vocab_names``: Megatron's placement with ``embed`` on its rows
        and ``lm_head`` on its columns) on (data=1, model=2): the reduced
        qwen3 (G=2, tied) and deepseek-v2 (untied, its experts on their
        expert dim) (``VOCAB_CASES``), each as an ``MP_MOE_CASES`` case:
        the first step's gradient, two placed steps and greedy serving
        (DIR/reference_vocab.pkl; DIR/port_vocab_<rank>.pkl, with the
        shapes of the logits each loss call got).

    python tests/torch_train_ranks.py reference DIR recurrent
    python tests/torch_train_ranks.py port DIR recurrent
        The reduced recurrentgemma-2b (H=4, KV=1, a tail layer) on
        (data=1, model=2), placed by ``recurrent_names``: the RG-LRU on its
        width, its local attention's query heads split with the one KV head
        replicated (MQA), the MLP Megatron-style and the vocabulary split;
        as an ``MP_MOE_CASES`` case (the first step's gradient, two placed
        steps, greedy serving) at sequences and a prompt past its window,
        the RG-LRU states placed on their width (DIR/reference_recurrent.pkl;
        DIR/port_recurrent_<rank>.pkl, with each rank's cache blocks).
    python tests/torch_train_ranks.py reference DIR xlstm
    python tests/torch_train_ranks.py port DIR xlstm
        The reduced xlstm-125m (12 layers, d=64, H=4, tied) on (data=1,
        model=2), placed by ``xlstm_names``: the mLSTM and sLSTM blocks on
        their heads, the vocabulary split; as an ``MP_MOE_CASES`` case (the
        first step's gradient, two placed steps, greedy serving), the
        states placed on their heads (DIR/reference_xlstm.pkl;
        DIR/port_xlstm_<rank>.pkl, with each rank's cache blocks and the
        heads and channels its xLSTM blocks computed).
    python tests/torch_train_ranks.py reference DIR frontend
    python tests/torch_train_ranks.py port DIR frontend
        hubert-xlarge (audio frames in, the non-causal encoder) and
        llava-next-mistral-7b (image embeddings in) reduced, on (data=1,
        model=2) placed by ``vocab_names`` (``FRONT_CASES``), each as an
        ``MP_MOE_CASES`` case: the first step's gradient and two placed
        steps; then hubert's forward, and llava's image request served
        greedily with K/V on their heads (DIR/reference_frontend.pkl;
        DIR/port_frontend_<rank>.pkl).
    python tests/torch_train_ranks.py reference DIR mesh22
    python tests/torch_train_ranks.py port DIR mesh22
        A mesh with both axes larger than one: (data=2, model=2) on 4
        forced host devices and 4 gloo ranks (``MESH22_CASES``): the reduced
        qwen3 (G=2, tied) placed by ``vocab_names`` and granite-moe-1b with
        its experts on their expert dim under ``moe_chunks`` 2, each as an
        ``MP_MOE_CASES`` case with the batch's rows over "data"; qwen3's
        greedy serving also on K/V placed on their slots with the rows over
        "data" (``_slot_split_decode``) and, with its parameters
        replicated, through the flash-decoding override
        (DIR/reference_mesh22.pkl; DIR/port_mesh22_<rank>.pkl, with every
        all-reduce's group).

The pickles are written and read by these two functions only.
"""

from __future__ import annotations

import contextlib
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


def batches(vocab: int, seq: int = T):
    """STEPS batches of B x ``seq`` tokens, each with a mask that drops
    other positions in each row, so that the ranks' token counts differ."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, seq + 1)).astype(np.int32)
        mask = rng.random((B, seq)) < np.linspace(0.3, 1.0, B)[:, None]
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask})
    return out


def case_batches(cfg, seq: int = T):
    """``batches`` for ``cfg``'s modality: an audio model's frames (B, seq,
    d) in place of its tokens, a vision model's image embeddings (B,
    n_image_tokens, vision_dim) beside them (drawn after the tokens, from
    a generator of their own)."""
    out = batches(cfg.vocab_size, seq)
    if cfg.modality not in ("audio", "vision_text"):
        return out
    rng = np.random.default_rng(12)
    for b in out:
        if cfg.modality == "audio":
            del b["tokens"]
            b["frames"] = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        else:
            b["image_embeds"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def serve_inputs(cfg, prompt: int) -> dict:
    """The serving request of two rows: ``prompt`` tokens (a vision model's
    image embeddings before them), or an audio model's ``prompt`` frames."""
    rng = np.random.default_rng(9)
    if cfg.modality == "audio":
        return {"frames": rng.standard_normal((2, prompt, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32)}
    if cfg.modality == "vision_text":
        out["image_embeds"] = np.random.default_rng(10).standard_normal(
            (2, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def first_position(cfg, inputs: dict) -> int:
    """The position of the first decode step after a prefill of ``inputs``
    (a vision model's image tokens come first)."""
    return inputs["tokens"].shape[1] + (cfg.n_image_tokens if "image_embeds" in inputs else 0)


# the placed cases: the mesh of each placement (its axes AXES, but for
# "model_only", a mesh of "model" alone); "apart" and "model_only" step
# the qwen3 cases only
PLACEMENTS = {"zero1": (2, 1), "model": (1, 2), "apart": (2, 1), "model_only": (2,)}
QWEN_ONLY = ("apart", "model_only")
EXPERTS = ("['w_gate']", "['w_up']", "['w_down']")


def axes_of(kind: str) -> tuple:
    return ("model",) if kind == "model_only" else AXES


def data_size(kind: str) -> int:
    """The data ranks of placement ``kind``'s mesh (1 without a data axis)."""
    return PLACEMENTS[kind][0] if "data" in axes_of(kind) else 1


def cases_of(kind: str) -> tuple:
    return CASES[:2] if kind in QWEN_ONLY else CASES


def placed_names(kind: str, path: str, shape, experts: bool) -> tuple:
    """The mesh axis of each dim of the state leaf at ``path`` (a
    ``PartitionSpec``'s entries; () replicates) under placement ``kind``:
    "zero1" splits the moments and residuals over "data" at their first
    dim that divides; "apart" the same but for ν, replicated (μ and ν of a
    leaf placed apart); "model" and "model_only" split the parameters,
    moments and residuals over "model", the experts of an MoE layer on
    their expert dim (as the reference's expert parallelism places them),
    every other leaf at its last dim that divides."""
    nd = len(shape)
    moment = path.startswith(("['opt']['mu']", "['opt']['nu']", "['compress']"))
    data = kind in ("zero1", "apart")
    if nd == 0 or (data and not moment) or (kind == "apart" and path.startswith("['opt']['nu']")):
        return ()
    axis = "data" if data else "model"
    if kind == "model" and experts and path.endswith(EXPERTS):
        dim = nd - 3                      # (E, d, f) after the tile axis
    else:
        dims = [d for d in range(nd) if shape[d] % 2 == 0]
        if not dims:
            return ()
        dim = dims[0] if data else dims[-1]
    return tuple(axis if d == dim else None for d in range(nd))


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


def reference_placed(out_dir: Path) -> None:
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

    flat = lambda tree: [(jax.tree_util.keystr(k), v)                  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    shards = lambda x: [np.asarray(s.data) for s in                    # noqa: E731
                        sorted(x.addressable_shards, key=lambda s: s.device.id)]
    res = {}
    for kind, shape in PLACEMENTS.items():
        mesh = make_mesh(shape, axes_of(kind))
        rows = P("data") if "data" in axes_of(kind) else P()
        for name, arch, mb, comp, chunks in cases_of(kind):
            cfg = get_config(arch).reduced()
            model = make_model(cfg, compute_dtype=jnp.float32)
            tcfg = TrainConfig(optimizer=AdamWConfig(**LR), microbatches=mb,
                               compute_dtype=jnp.float32,
                               compression=CompressionConfig(min_size=COMPRESS_MIN) if comp
                               else None)
            state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
            specs = jax.tree_util.tree_map_with_path(
                lambda k, a: NamedSharding(mesh, P(*placed_names(
                    kind, jax.tree_util.keystr(k), np.shape(a), bool(cfg.moe)))), state)
            state = reshard_state(state, specs)
            case = {"params": jax.tree.map(np.asarray, state["params"]),
                    "before": {p: shards(x) for p, x in flat(state)}}
            # chunks of the MoE position assignment: one a data rank, as the port
            with shardctx.rules({"moe_chunks": shape[0]} if chunks else {}):
                step = jax.jit(make_train_step(model, tcfg))
                losses = []
                for b in batches(cfg.vocab_size):
                    b = {k: jax.device_put(v, NamedSharding(mesh, rows)) for k, v in b.items()}
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
            case.update(losses=losses, state=dict(flat(jax.tree.map(np.asarray, state))))
            res[kind, name] = case
            # the same step on one device: where the placed program's own
            # rounding moves an element, the test looks here
            rules = {"moe_chunks": shape[0]} if chunks else {}
            key = ("single", name, tuple(rules.items()))
            if key not in res:
                state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
                with shardctx.rules(rules):
                    step = jax.jit(make_train_step(model, tcfg))
                    for b in batches(cfg.vocab_size):
                        state, _ = step(state, b)
                res[key] = dict(flat(jax.tree.map(np.asarray, state)))
            case["single"] = key
    with open(out_dir / "reference_placed.pkl", "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the port (torch.distributed, gloo)
# ---------------------------------------------------------------------------
def _setup(ref_case, arch, mb, comp, cfg=None):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import from_jax_params, make_model
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training.compression import CompressionConfig, compression_init
    from repro_torch.training.optimizer import adamw_init

    cfg = cfg or get_config(arch).reduced()
    model = make_model(cfg, compute_dtype=torch.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(**LR), microbatches=mb, compute_dtype=torch.float32,
                       compression=CompressionConfig(min_size=COMPRESS_MIN) if comp else None)
    params = from_jax_params(ref_case["params"], cfg, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    if comp:
        state["compress"] = compression_init(params)
    return cfg, model, tcfg, state


def _port_rank(rank: int, world: int, out_dir: str, tag: str = "") -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank)
    try:
        with open(Path(out_dir) / f"reference{tag}.pkl", "rb") as f:
            ref = pickle.load(f)
        res = {"": _port_cases, "_placed": _port_placed, "_megatron": _port_megatron,
               "_vocab": _port_vocab, "_recurrent": _port_recurrent,
               "_mesh22": _port_mesh22, "_xlstm": _port_xlstm,
               "_frontend": _port_frontend}[tag](ref, Path(out_dir))
        with open(Path(out_dir) / f"port{tag}_{rank}.pkl", "wb") as f:
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


def _port_placed(ref, out_dir: Path) -> dict:
    import torch

    from repro_torch.launch.mesh import Sharding, make_mesh
    from repro_torch.training import make_train_step
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    res = {}
    for kind, shape in PLACEMENTS.items():
        mesh = make_mesh(shape, axes_of(kind), device="cpu")
        ds = data_size(kind)
        di = mesh.get_coordinate()[0] if ds > 1 else 0
        rows = slice(di * B // ds, (di + 1) * B // ds)

        def specs(tree, cfg):
            return unflatten(tree, [Sharding(mesh, placed_names(kind, p, tuple(x.shape),
                                                                bool(cfg.moe)))
                                    for p, x in flatten_with_paths(tree)])

        for name, arch, mb, comp, chunks in cases_of(kind):
            r = ref[kind, name]
            cfg, model, tcfg, state = _setup(r, arch, mb, comp)
            if kind == "zero1" and name == CASES[0][0]:
                # the world-1 checkpoint restored onto the ZeRO-1 placements
                w1 = world1_state({"cases": {name: r}})
                back, _ = Checkpointer(out_dir / "ckpt1").restore(None, w1, specs(w1, cfg))
                res["restored"] = {p: x.to_local().numpy() for p, x in flatten_with_paths(back)}
            placed = reshard_state(state, specs(state, cfg))
            case = {"before": {p: x.to_local().numpy().copy()
                               for p, x in flatten_with_paths(placed)},
                    "bytes": {p: x.to_local().numel() * x.element_size()
                              for p, x in flatten_with_paths(placed)}}
            step = make_train_step(model, tcfg)
            losses, calls = [], []
            for b in batches(cfg.vocab_size):
                placed, m = step(placed, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
                losses.append(float(m["loss"]))
                calls.append({k: int(v) for k, v in m.items() if k.startswith("collectives")})
            case.update(losses=losses, calls=calls,
                        placements={p: str(tuple(x.placements))
                                    for p, x in flatten_with_paths(placed)},
                        state={p: x.full_tensor().numpy() for p, x in flatten_with_paths(placed)})
            res[kind, name] = case
            if kind == "zero1" and name == CASES[0][0]:
                Checkpointer(out_dir / "ckpt_zero1").save(STEPS, placed, {"step": STEPS})
    return res


# ---------------------------------------------------------------------------
# partitioned compute over "model" (tests/test_torch_model_parallel.py)
# ---------------------------------------------------------------------------
# the reduced qwen3 with G = 2 (H=4, KV=2: each of 2 model ranks 2 and 1)
MP_ARCH, MP_CFG = "qwen3-1.7b", {"n_kv_heads": 2}
# the meshes: (data=1, model=2), and "model" alone
MP_MESHES = {"dm": ((1, 2), ("data", "model")), "m": ((2,), ("model",))}
MP_CASES = CASES[:2]                    # microbatches 1; 2 with int8 compression
MP_PROMPT, MP_CACHE, MP_DECODE = 5, 16, 4
COLUMN = ("['wq']", "['wk']", "['wv']", "['wq_b']", "['w_uk']", "['w_uv']", "['w_gate']",
          "['w_up']")
ROW = ("['wo']", "['w_down']")
EXPERT_LEAVES = ("['ffn']['w_gate']", "['ffn']['w_up']", "['ffn']['w_down']")
# the MoE families on (data=1, model=2): (name, arch, the experts' role)
MP_MOE_CASES = (("granite_expert", "granite-moe-1b-a400m", "expert"),
                ("granite_column", "granite-moe-1b-a400m", "column"),
                ("deepseek_expert", "deepseek-v2-236b", "expert"))
# granite's experts on their expert dim under the launcher's expert-parallel
# override (launch/moe_ep.py), attention partitioned or replicated: (name,
# whether attention is split); a prompt that splits over "model", so that
# the prefill takes the override too
MP_EP_ARCH, MP_EP_PROMPT = "granite-moe-1b-a400m", 6
MP_EP_CASES = (("granite_ep_attn", True), ("granite_ep_replicated", False))
# the vocabulary split over "model" too, on (data=1, model=2): (name, arch,
# config changes, the experts' role)
VOCAB_CASES = (("qwen3_tied", MP_ARCH, MP_CFG, "column"),
               ("deepseek_untied", "deepseek-v2-236b", {}, "expert"))


def megatron_names(mesh_name: str, path: str, shape, experts: str = "column") -> tuple:
    """Megatron's placement of the state leaf (or parameter) at ``path``:
    the column leaves (wq, wk, wv; MLA's wq_b, w_uk, w_uv; w_gate, w_up)
    split over "model" on their last dim, the row leaves (wo, w_down) on
    the dim before it, their moments and residuals alike; an MoE layer's
    routed experts ((E, d, f) after the tiles' dim) so too, or with
    ``experts="expert"`` on their expert dim; every other leaf replicated,
    but on the mesh of "model" alone the (tied) embedding, split on its
    last dim, which the port gathers (the gathered route beside the
    partitioned one)."""
    nd = len(shape)
    lead = 1 if "['blocks']" in path else 0
    if experts == "expert" and nd == lead + 3 and path.endswith(EXPERT_LEAVES):
        return (None,) * lead + ("model", None, None)
    if nd and path.endswith(COLUMN):
        return (None,) * (nd - 1) + ("model",)
    if nd and path.endswith(ROW):
        return (None,) * (nd - 2) + ("model", None)
    if nd and mesh_name == "m" and path.endswith("['embed']"):
        return (None,) * (nd - 1) + ("model",)
    return ()


def vocab_names(path: str, shape, experts: str = "column") -> tuple:
    """``megatron_names`` on (data=1, model=2) with the vocabulary split over
    "model" too: ``embed`` (V, d) on its rows, ``lm_head`` (d, V) on its
    columns, their moments and residuals alike. Every leaf left replicated
    is a norm, the router or one of MLA's down-projections."""
    if len(shape) == 2 and path.endswith("['embed']"):
        return ("model", None)
    if len(shape) == 2 and path.endswith("['lm_head']"):
        return (None, "model")
    return megatron_names("dm", path, shape, experts)


# recurrentgemma partitioned over "model" (data=1, model=2): the reduced
# config with a tail layer (8 layers: 2 tiles of (rglru, rglru, local) and
# two RG-LRU layers after them), its training sequences and its prompt past
# the window of 32, the cache's slots and the decode steps
REC_ARCH, REC_CFG = "recurrentgemma-2b", {"n_layers": 8}
REC_SEQ, REC_PROMPT, REC_CACHE = 40, 40, 48
# the RG-LRU's leaves in its "core" dict: split on their last dim (the
# column products and the per-channel leaves) or on the dim before it (w_out)
RGLRU_LAST = ("['core']['wx']", "['core']['wgate']", "['core']['w_input_gate']",
              "['core']['w_rec_gate']", "['core']['log_lambda']", "['core']['conv']['w']",
              "['core']['conv']['b']")
RGLRU_ROW = ("['core']['w_out']",)
MQA_KV = ("['attn']['wk']", "['attn']['wv']")


def recurrent_names(path: str, shape, experts: str = "column") -> tuple:
    """recurrentgemma's placement: ``vocab_names`` (Megatron's with the
    vocabulary split), but MQA's wk and wv replicated (the one KV head on
    every rank), and the RG-LRU's leaves on their width (``RGLRU_LAST`` on
    their last dim, w_out on the dim before it)."""
    nd = len(shape)
    if path.endswith(MQA_KV):
        return ()
    if nd and path.endswith(RGLRU_LAST):
        return (None,) * (nd - 1) + ("model",)
    if nd and path.endswith(RGLRU_ROW):
        return (None,) * (nd - 2) + ("model", None)
    return vocab_names(path, shape, experts)


# xlstm-125m partitioned over "model" on its heads (data=1, model=2): the
# reduced config (12 layers: two tiles of five mLSTM blocks and an sLSTM,
# d=64, H=4, the vocabulary of 512 tied)
XL_ARCH, XL_CFG = "xlstm-125m", {"n_layers": 6}
# the xLSTM's leaves in its "core" dict: split on their last dim (the
# mLSTM's column products, its conv and both blocks' norm channels), on the
# dim before it (the mLSTM's w_down, the sLSTM's w_ff_up: rows), on H (the
# sLSTM's recurrent weights (H, dh, dh)), or replicated (the sLSTM's w_in
# and w_ff_down)
XLSTM_LAST = ("['core']['w_up']", "['core']['w_gate_up']", "['core']['wq']", "['core']['wk']",
              "['core']['wv']", "['core']['w_igate']", "['core']['w_fgate']",
              "['core']['conv']['w']", "['core']['conv']['b']", "['core']['out_norm']['scale']")
XLSTM_ROW = ("['core']['w_down']", "['core']['w_ff_up']")
XLSTM_HEAD = ("['core']['r_i']", "['core']['r_f']", "['core']['r_z']", "['core']['r_o']")
XLSTM_REPLICATED = ("['core']['w_in']", "['core']['w_ff_down']")
SLSTM_W_IN = "['core']['w_in']"


def xlstm_names(path: str, shape, experts: str = "column") -> tuple:
    """xlstm-125m's placement: ``vocab_names`` (the tied embedding on its
    vocabulary) with the xLSTM blocks on their heads: ``XLSTM_LAST`` on
    their last dim, ``XLSTM_ROW`` on the dim before it, ``XLSTM_HEAD`` on
    H, the sLSTM's w_in and w_ff_down replicated."""
    nd = len(shape)
    if path.endswith(XLSTM_REPLICATED):
        return ()
    if nd and path.endswith(XLSTM_LAST):
        return (None,) * (nd - 1) + ("model",)
    if nd and path.endswith(XLSTM_ROW):
        return (None,) * (nd - 2) + ("model", None)
    if nd >= 3 and path.endswith(XLSTM_HEAD):
        return (None,) * (nd - 3) + ("model", None, None)
    return vocab_names(path, shape, experts)


def _xlstm_cache_spec(path: str, c):
    """xlstm-125m's caches as the port holds them: the mLSTM's conv inputs
    on their channels, every other state on its heads (the dim after the
    batch), over "model"."""
    if path.endswith("['conv']"):
        return (None,) * (c.ndim - 1) + ("model",)
    lead = 1 if path.startswith("['blocks']") else 0
    return (None,) * (lead + 1) + ("model",) + (None,) * (c.ndim - lead - 2)


# hubert-xlarge's encoder and llava's image request partitioned (data=1,
# model=2), placed by vocab_names: (name, arch); llava's cache holds its 8
# image tokens, the prompt and the decode steps
FRONT_CASES = (("hubert", "hubert-xlarge"), ("llava", "llava-next-mistral-7b"))
FRONT_CACHE = 24

# (data=2, model=2): (name, arch, config changes, the experts' role, whether
# the vocabulary is split, the reference's moe_chunks)
MESH22 = ((2, 2), ("data", "model"))
MESH22_CASES = (("qwen3_vocab", MP_ARCH, MP_CFG, "column", True, 0),
                ("granite_expert", "granite-moe-1b-a400m", {}, "expert", False, 2))


def case_names(path: str, shape, experts: str, vocab: bool) -> tuple:
    """The placement of an ``MP_MOE_CASES`` case, or with ``vocab`` of a
    ``VOCAB_CASES`` one."""
    return vocab_names(path, shape, experts) if vocab else megatron_names("dm", path, shape,
                                                                          experts)


def ep_names(path: str, shape, attn: bool) -> tuple:
    """An ``MP_EP_CASES`` placement: the routed experts on their expert
    dim, and with ``attn`` GQA's leaves as Megatron places them; every
    other leaf replicated."""
    spec = megatron_names("dm", path, shape, "expert")
    return spec if attn or path.endswith(EXPERT_LEAVES) else ()


def reference_megatron(out_dir: Path) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import make_model
    from repro.training import AdamWConfig, TrainConfig, make_train_step
    from repro.training.compression import CompressionConfig
    from repro.training.elastic import reshard_state
    from repro.training.train_step import init_train_state

    flat = lambda tree: [(jax.tree_util.keystr(k), v)                  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    cfg = dataclasses.replace(get_config(MP_ARCH).reduced(), **MP_CFG)
    model = make_model(cfg, compute_dtype=jnp.float32)
    res = {}
    for mname, (shape, axes) in MP_MESHES.items():
        mesh = make_mesh(shape, axes)
        rows = P("data") if "data" in axes else P()
        for name, arch, mb, comp, _ in MP_CASES:
            tcfg = TrainConfig(optimizer=AdamWConfig(**LR), microbatches=mb,
                               compute_dtype=jnp.float32,
                               compression=CompressionConfig(min_size=COMPRESS_MIN) if comp
                               else None)
            state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
            params = jax.tree.map(np.asarray, state["params"])
            specs = jax.tree_util.tree_map_with_path(
                lambda k, a, mname=mname, mesh=mesh: NamedSharding(mesh, P(*megatron_names(
                    mname, jax.tree_util.keystr(k), np.shape(a)))), state)
            state = reshard_state(state, specs)
            step = jax.jit(make_train_step(model, tcfg))
            losses = []
            for b in batches(cfg.vocab_size):
                b = {k: jax.device_put(v, NamedSharding(mesh, rows)) for k, v in b.items()}
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            case = dict(params=params, losses=losses,
                        state=dict(flat(jax.tree.map(np.asarray, state))))
            # the same steps on one device (the rounding rule of the tests)
            key = ("single", name)
            if key not in res:
                single = init_train_state(model, jax.random.PRNGKey(0), tcfg)
                step = jax.jit(make_train_step(model, tcfg))
                for b in batches(cfg.vocab_size):
                    single, _ = step(single, b)
                res[key] = dict(flat(jax.tree.map(np.asarray, single)))
            case["single"] = key
            res[mname, name] = case
    # serving: the parameters placed so, prefill, greedy decode steps on K/V
    # caches split on their heads
    mesh = make_mesh(*MP_MESHES["dm"])
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    placed = reshard_state(params, jax.tree_util.tree_map_with_path(
        lambda k, a: NamedSharding(mesh, P(*megatron_names(
            "dm", jax.tree_util.keystr(k), np.shape(a)))), params))

    def heads(path, c):
        spec = (None,) * (c.ndim - 2) + ("model", None)
        return jax.lax.with_sharding_constraint(c, NamedSharding(mesh, P(*spec)))

    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, MP_PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, MP_CACHE))
    decode = jax.jit(model.decode_step)
    logits, caches = prefill(placed, toks)
    caches = jax.tree_util.tree_map_with_path(heads, caches)
    out, new = [np.asarray(logits)], []
    for i in range(MP_DECODE):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        new.append(np.asarray(tok))
        pos = jnp.full((2,), MP_PROMPT + i, jnp.int32)
        logits, caches = decode(placed, tok, caches, pos)
        caches = jax.tree_util.tree_map_with_path(heads, caches)
        out.append(np.asarray(logits))
    res["serve"] = dict(params=jax.tree.map(np.asarray, params), tokens=toks,
                        logits=out, greedy=np.concatenate(new, axis=1),
                        caches=dict(flat(jax.tree.map(np.asarray, caches))))
    for name, arch, role in MP_MOE_CASES:
        res[name] = _reference_moe(mesh, arch, role)
    for name, attn in MP_EP_CASES:
        res[name] = _reference_ep(mesh, attn)
    with open(out_dir / "reference_megatron.pkl", "wb") as f:
        pickle.dump(res, f)


def _reference_moe(mesh, arch: str, role: str, changes=None, vocab: bool = False, *,
                   names=None, seq: int = T, prompt: int = MP_PROMPT, cache: int = MP_CACHE,
                   chunks: int = 0, cache_spec=None) -> dict:
    """An MoE case of ``reference_megatron`` on ``mesh`` (data=1, model=2):
    the state placed by ``megatron_names`` with the experts in ``role``
    (with ``vocab``, by ``vocab_names``; with ``names``, by
    ``names(path, shape)``; the reduced config with ``changes``), the first
    batch's gradient of the placed parameters and two placed ``jax.jit``
    steps on batches of ``seq`` tokens (their rows on P("data"); with
    ``chunks``, under that ``moe_chunks``); then fresh parameters so
    placed, a prefill of ``prompt`` tokens into ``cache`` slots and greedy
    decode steps (GQA's K and V placed on their heads, or each cache leaf
    by ``cache_spec(path, leaf)`` where given; MLA's latent cache as the
    program leaves it), and the caches after them."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.models import make_model, shardctx
    from repro.training import AdamWConfig, TrainConfig, make_train_step
    from repro.training.elastic import reshard_state
    from repro.training.train_step import init_train_state, make_loss_fn

    flat = lambda tree: [(jax.tree_util.keystr(k), v)                  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    cfg = dataclasses.replace(get_config(arch).reduced(), **(changes or {}))
    model = make_model(cfg, compute_dtype=jnp.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(**LR), compute_dtype=jnp.float32)

    def specs(tree):
        return jax.tree_util.tree_map_with_path(
            lambda k, a: NamedSharding(mesh, P(*(names or (lambda p, sh: case_names(
                p, sh, role, vocab)))(jax.tree_util.keystr(k), np.shape(a)))), tree)

    state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
    out = dict(params=jax.tree.map(np.asarray, state["params"]))
    state = reshard_state(state, specs(state))
    put = lambda b: {k: jax.device_put(v, NamedSharding(mesh, P("data")))  # noqa: E731
                     for k, v in b.items()}
    bs = case_batches(cfg, seq)
    with shardctx.rules({"moe_chunks": chunks} if chunks else {}):
        loss_fn = make_loss_fn(model, tcfg)
        grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(state["params"], put(bs[0]))
        out["grad"] = dict(flat(jax.tree.map(np.asarray, grad)))
        step = jax.jit(make_train_step(model, tcfg))
        losses = []
        for b in bs:
            state, m = step(state, put(b))
            losses.append(float(m["loss"]))
    out.update(losses=losses, state=dict(flat(jax.tree.map(np.asarray, state))))

    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    placed = reshard_state(params, specs(params))

    def heads(path, c):
        if cache_spec is not None:
            spec = cache_spec(jax.tree_util.keystr(path), c)
            return c if spec is None else jax.lax.with_sharding_constraint(
                c, NamedSharding(mesh, P(*spec)))
        if jax.tree_util.keystr(path).endswith(("['k']", "['v']")):
            spec = (None,) * (c.ndim - 2) + ("model", None)
            return jax.lax.with_sharding_constraint(c, NamedSharding(mesh, P(*spec)))
        return c

    inputs = serve_inputs(cfg, prompt)
    if cfg.modality == "audio":            # an encoder: one forward, no decode
        logits = jax.jit(model.forward_logits)(placed, inputs)
        out["serve"] = dict(params=jax.tree.map(np.asarray, params), inputs=inputs,
                            logits=[np.asarray(logits)])
        return out
    start = first_position(cfg, inputs)
    prefill = jax.jit(lambda p, b: model.prefill(p, b, cache))
    decode = jax.jit(model.decode_step)
    logits, caches = prefill(placed, inputs)
    caches = jax.tree_util.tree_map_with_path(heads, caches)
    got, new = [np.asarray(logits)], []
    for i in range(MP_DECODE):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        new.append(np.asarray(tok))
        logits, caches = decode(placed, tok, caches, jnp.full((2,), start + i, jnp.int32))
        caches = jax.tree_util.tree_map_with_path(heads, caches)
        got.append(np.asarray(logits))
    out["serve"] = dict(params=jax.tree.map(np.asarray, params), tokens=inputs["tokens"],
                        inputs=inputs, logits=got, greedy=np.concatenate(new, axis=1),
                        caches=dict(flat(jax.tree.map(np.asarray, caches))))
    return out


def _reference_ep(mesh, attn: bool) -> dict:
    """An ``MP_EP_CASES`` case of ``reference_megatron``: two placed
    ``jax.jit`` steps and greedy serving (K and V placed on their heads
    where attention is split), each traced under the reference's
    expert-parallel ``moe_apply`` override."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.moe_ep import make_moe_apply_ep
    from repro.models import make_model, shardctx
    from repro.training import AdamWConfig, TrainConfig, make_train_step
    from repro.training.elastic import reshard_state
    from repro.training.train_step import init_train_state

    flat = lambda tree: [(jax.tree_util.keystr(k), v)                  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    cfg = get_config(MP_EP_ARCH).reduced()
    model = make_model(cfg, compute_dtype=jnp.float32)
    tcfg = TrainConfig(optimizer=AdamWConfig(**LR), compute_dtype=jnp.float32)

    def specs(tree):
        return jax.tree_util.tree_map_with_path(
            lambda k, a: NamedSharding(mesh, P(*ep_names(jax.tree_util.keystr(k), np.shape(a),
                                                         attn))), tree)

    def heads(path, c):
        if not attn:
            return c
        spec = (None,) * (c.ndim - 2) + ("model", None)
        return jax.lax.with_sharding_constraint(c, NamedSharding(mesh, P(*spec)))

    with shardctx.rules({"moe_apply": make_moe_apply_ep(mesh, cfg)}):
        state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
        out = dict(params=jax.tree.map(np.asarray, state["params"]))
        state = reshard_state(state, specs(state))
        step = jax.jit(make_train_step(model, tcfg))
        losses = []
        for b in batches(cfg.vocab_size):
            state, m = step(state, {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        out.update(losses=losses, state=dict(flat(jax.tree.map(np.asarray, state))))
        params = jax.jit(model.init)(jax.random.PRNGKey(1))
        placed = reshard_state(params, specs(params))
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                 (2, MP_EP_PROMPT)).astype(np.int32)
        logits, caches = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, MP_CACHE))(
            placed, toks)
        caches = jax.tree_util.tree_map_with_path(heads, caches)
        decode = jax.jit(model.decode_step)
        got, new = [np.asarray(logits)], []
        for i in range(MP_DECODE):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            new.append(np.asarray(tok))
            logits, caches = decode(placed, tok, caches,
                                    jnp.full((2,), MP_EP_PROMPT + i, jnp.int32))
            caches = jax.tree_util.tree_map_with_path(heads, caches)
            got.append(np.asarray(logits))
    out["serve"] = dict(params=jax.tree.map(np.asarray, params), tokens=toks, logits=got,
                        greedy=np.concatenate(new, axis=1))
    return out


@contextlib.contextmanager
def _spied():
    """Spies, as lists in the dict yielded: the heads each K3 call gets
    (``heads``), the gradients each rank reduces (``grads``, the first
    step's kept) and what it makes of them (``reduced``, the first step's),
    the MoE routings (``routes``), the logits each loss call gets (``ce``:
    the function's name and the logits' shape), the q and KV heads of each
    chunked (windowed) attention call (``attn``), the channels each RG-LRU
    scan or step computes (``lru``), the xLSTM's work (``xlstm``: the
    channels each out_norm normalises, the heads each sLSTM cell step and
    each mLSTM sequence form computes), the leaves whose gradient the step
    sums over "model" (``partial``, the first step's), the shapes of the
    parameters the step gathers whole (``gathered``), every all-reduce's
    and all-gather's group (``coll``: the kind and the group's ranks), the
    collectives of each gradient's reduction (``reduce_groups``) and the
    groups of flash-decoding's gathers (``gather_cat``)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import flash_decode
    from repro_torch.models import attention, moe, rglru, transformer, xlstm
    from repro_torch.training import data_parallel

    spies = dict(heads=[], grads=[], reduced=[], routes=[], ce=[], attn=[], lru=[], xlstm=[],
                 partial=[], gathered=[], coll=[], reduce_groups=[], gather_cat=[])
    k3, route = ops.flash_attention, moe.moe_route
    reduce, reduce_one = data_parallel.Placed.reduce_grads, data_parallel.DataParallel.reduce_grad
    sum_partial, full = data_parallel.Placed.sum_partial, data_parallel.DataParallel.full
    plain_ce, vocab_ce = transformer.softmax_cross_entropy, transformer.vocab_parallel_cross_entropy
    chunked, scan, lru_step = attention.chunked_attention, rglru.rglru_scan, rglru.rglru_step
    all_reduce, all_gather, gather_cat = dist.all_reduce, dist.all_gather, flash_decode.gather_cat
    out_norm, cell = xlstm._out_norm, xlstm._slstm_cell
    parallel_form, chunkwise = xlstm.mlstm_parallel, xlstm.mlstm_chunkwise

    def ranks_of(group):
        return tuple(dist.get_process_group_ranks(group)) if group is not None else tuple(
            range(dist.get_world_size()))

    def k3_spy(q, k, v, **kw):
        spies["heads"].append((q.shape[2], k.shape[2]))
        return k3(q, k, v, **kw)

    def reduce_spy(self, gs):
        if not spies["grads"]:
            spies["grads"].append([g.detach().clone() for g in gs])
        out = reduce(self, gs)
        if not spies["reduced"]:
            spies["reduced"].append([g.detach().clone() for g in out])
        return out

    def reduce_one_spy(self, g, layout):
        n = len(spies["coll"])
        out = reduce_one(self, g, layout)
        spies["reduce_groups"].append(spies["coll"][n:])
        return out

    def partial_spy(self, grads):
        if not spies["partial"]:
            spies["partial"].append(list(self.partial))
        return sum_partial(self, grads)

    def full_spy(self, x, layout):
        if any(d is not None for d in layout):
            spies["gathered"].append(tuple(x.shape))
        return full(self, x, layout)

    def route_spy(*args, **kw):
        r = route(*args, **kw)
        spies["routes"].append((r["keep"].numpy().copy(), r["dest"].numpy().copy()))
        return r

    def ce_spy(fn):
        def spy(logits, *args, **kw):
            spies["ce"].append((fn.__name__, tuple(logits.shape)))
            return fn(logits, *args, **kw)
        return spy

    def chunked_spy(q, k, v, **kw):
        spies["attn"].append((q.shape[2], k.shape[2]))
        return chunked(q, k, v, **kw)

    def scan_spy(xc, *args, **kw):
        spies["lru"].append(xc.shape[-1])
        return scan(xc, *args, **kw)

    def step_spy(x_t, *args, **kw):
        spies["lru"].append(x_t.shape[-1])
        return lru_step(x_t, *args, **kw)

    def norm_spy(h, p, cfg, parallel=None):
        spies["xlstm"].append(("out_norm", h.shape[-1]))
        return out_norm(h, p, cfg, parallel)

    def cell_spy(carry, gx, r):
        spies["xlstm"].append(("slstm", gx.shape[-2]))
        return cell(carry, gx, r)

    def mlstm_spy(fn):
        def spy(q, *args, **kw):
            spies["xlstm"].append(("mlstm", q.shape[2]))
            return fn(q, *args, **kw)
        return spy

    def all_reduce_spy(t, *args, group=None, **kw):
        spies["coll"].append(("all_reduce", ranks_of(group)))
        return all_reduce(t, *args, group=group, **kw)

    def all_gather_spy(out, t, *args, group=None, **kw):
        spies["coll"].append(("all_gather", ranks_of(group)))
        return all_gather(out, t, *args, group=group, **kw)

    def gather_cat_spy(x, group, order, dim=0):
        spies["gather_cat"].append(ranks_of(group))
        return gather_cat(x, group, order, dim)

    patches = [(ops, "flash_attention", k3_spy), (moe, "moe_route", route_spy),
               (data_parallel.Placed, "reduce_grads", reduce_spy),
               (data_parallel.DataParallel, "reduce_grad", reduce_one_spy),
               (data_parallel.Placed, "sum_partial", partial_spy),
               (data_parallel.DataParallel, "full", full_spy),
               (transformer, "softmax_cross_entropy", ce_spy(plain_ce)),
               (transformer, "vocab_parallel_cross_entropy", ce_spy(vocab_ce)),
               (attention, "chunked_attention", chunked_spy), (rglru, "rglru_scan", scan_spy),
               (rglru, "rglru_step", step_spy), (xlstm, "_out_norm", norm_spy),
               (xlstm, "_slstm_cell", cell_spy),
               (xlstm, "mlstm_parallel", mlstm_spy(parallel_form)),
               (xlstm, "mlstm_chunkwise", mlstm_spy(chunkwise)),
               (dist, "all_reduce", all_reduce_spy),
               (dist, "all_gather", all_gather_spy), (flash_decode, "gather_cat", gather_cat_spy)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, spy in patches:
        setattr(obj, name, spy)
    try:
        yield spies
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _port_megatron(ref, out_dir: Path) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.flash_decode import SplitCaches
    from repro_torch.launch.mesh import Sharding, make_mesh
    from repro_torch.models import from_jax_params, make_model, shardctx
    from repro_torch.training import make_train_step
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    cfg = dataclasses.replace(get_config(MP_ARCH).reduced(), **MP_CFG)
    model = make_model(cfg, compute_dtype=torch.float32)
    res = {}
    with _spied() as spies:
        heads, grads = spies["heads"], spies["grads"]
        for mname, (shape, axes) in MP_MESHES.items():
            mesh = make_mesh(shape, axes, device="cpu")

            def specs(tree, mname=mname, mesh=mesh):
                return unflatten(tree, [Sharding(mesh, megatron_names(mname, p, tuple(x.shape)))
                                        for p, x in flatten_with_paths(tree)])

            for name, arch, mb, comp, _ in MP_CASES:
                r = ref[mname, name]
                _, _, tcfg, state = _setup(r, arch, mb, comp, cfg)
                placed = reshard_state(state, specs(state))
                step = make_train_step(model, tcfg)
                losses, calls = [], []
                heads.clear()
                grads.clear()
                for b in batches(cfg.vocab_size):           # every rank the whole batch
                    placed, m = step(placed, {k: torch.from_numpy(v) for k, v in b.items()})
                    losses.append(float(m["loss"]))
                    calls.append({k: int(v) for k, v in m.items()
                                  if k.startswith("collectives")})
                paths = [p for p, _ in flatten_with_paths(placed["params"])]
                res[mname, name] = dict(
                    losses=losses, calls=calls, k3_heads=sorted(set(heads)),
                    grad_bytes={p: g.numel() * g.element_size()
                                for p, g in zip(paths, grads[0])},
                    bytes={p: x.to_local().numel() * x.element_size()
                           for p, x in flatten_with_paths(placed)},
                    state={p: x.full_tensor().numpy() for p, x in flatten_with_paths(placed)})
        # serving on (data=1, model=2)
        mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
        sv = ref["serve"]
        params = from_jax_params(sv["params"], cfg, device="cpu")
        placed = reshard_state(params, unflatten(params, [
            Sharding(mesh, megatron_names("dm", p, tuple(x.shape)))
            for p, x in flatten_with_paths(params)]))
        split = SplitCaches(mesh, model, placed)
        toks = torch.from_numpy(sv["tokens"]).long()
        heads.clear()
        with torch.no_grad(), shardctx.rules({"cache_split": split}):
            logits, caches = model.prefill(placed, {"tokens": toks}, MP_CACHE)
            prefill_heads = sorted(set(heads))
            out, new = [logits.numpy()], []
            for i in range(MP_DECODE):
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                new.append(tok.numpy())
                pos = torch.full((2,), MP_PROMPT + i, dtype=torch.int32)
                logits, caches = model.decode_step(placed, tok, caches, pos)
                out.append(logits.numpy())
        res["serve"] = dict(
            slots=_slot_split_decode(model, sv, placed, mesh),
            logits=out, greedy=np.concatenate(new, axis=1), k3_heads=prefill_heads,
            kinds=dict(split.parallel.kinds), families=sorted(split.parallel.families),
            cache={p: (tuple(x.to_local().shape), x.to_local().numel() * x.element_size(),
                       x.numel() * x.element_size(), str(tuple(x.placements)))
                   for p, x in flatten_with_paths(caches)})
        mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
        for name, arch, role in MP_MOE_CASES:
            res[name] = _port_moe(ref[name], arch, role, mesh, spies)
        for name, attn in MP_EP_CASES:
            res[name] = _port_ep(ref[name], attn, mesh)
    return res


def reference_vocab(out_dir: Path) -> None:
    from repro.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"])
    res = {name: _reference_moe(mesh, arch, role, changes, vocab=True)
           for name, arch, changes, role in VOCAB_CASES}
    with open(out_dir / "reference_vocab.pkl", "wb") as f:
        pickle.dump(res, f)


def _rec_cache_spec(path: str, c):
    """recurrentgemma's caches as the port holds them: an RG-LRU layer's
    state on its width over "model", MQA's one K/V head whole."""
    if path.endswith(("['h']", "['conv']")):
        return (None,) * (c.ndim - 1) + ("model",)
    return ()


def reference_recurrent(out_dir: Path) -> None:
    from repro.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"])
    res = {"recurrent": _reference_moe(mesh, REC_ARCH, "column", REC_CFG, names=recurrent_names,
                                       seq=REC_SEQ, prompt=REC_PROMPT, cache=REC_CACHE,
                                       cache_spec=_rec_cache_spec)}
    with open(out_dir / "reference_recurrent.pkl", "wb") as f:
        pickle.dump(res, f)


def reference_xlstm(out_dir: Path) -> None:
    from repro.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"])
    res = {"xlstm": _reference_moe(mesh, XL_ARCH, "column", XL_CFG, names=xlstm_names,
                                   cache_spec=_xlstm_cache_spec)}
    with open(out_dir / "reference_xlstm.pkl", "wb") as f:
        pickle.dump(res, f)


def reference_frontend(out_dir: Path) -> None:
    from repro.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"])
    res = {name: _reference_moe(mesh, arch, "column", vocab=True, cache=FRONT_CACHE)
           for name, arch in FRONT_CASES}
    with open(out_dir / "reference_frontend.pkl", "wb") as f:
        pickle.dump(res, f)


def reference_mesh22(out_dir: Path) -> None:
    from repro.launch.mesh import make_mesh

    mesh = make_mesh(*MESH22)
    res = {name: _reference_moe(mesh, arch, role, changes, vocab, chunks=chunks)
           for name, arch, changes, role, vocab, chunks in MESH22_CASES}
    with open(out_dir / "reference_mesh22.pkl", "wb") as f:
        pickle.dump(res, f)


def _port_recurrent(ref, out_dir: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh

    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Sharding
    from repro_torch.models import from_jax_params, make_model
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
    with _spied() as spies:
        out = _port_moe(ref["recurrent"], REC_ARCH, "column", mesh, spies, REC_CFG,
                        names=recurrent_names, seq=REC_SEQ, prompt=REC_PROMPT, cache=REC_CACHE)
    # the same serving parameters on K and V placed on their slots and the
    # states whole: gathered for each step, the rank's channels handed on
    cfg = dataclasses.replace(get_config(REC_ARCH).reduced(), **REC_CFG)
    model = make_model(cfg, compute_dtype=torch.float32)
    sv = ref["recurrent"]["serve"]
    params = from_jax_params(sv["params"], cfg, device="cpu")
    placed = reshard_state(params, unflatten(params, [
        Sharding(mesh, recurrent_names(p, tuple(x.shape))) for p, x in flatten_with_paths(params)]))
    out["slots"] = _slot_split_decode(model, sv, placed, mesh, REC_PROMPT, REC_CACHE)
    return {"recurrent": out}


def _port_xlstm(ref, out_dir: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
    with _spied() as spies:
        return {"xlstm": _port_moe(ref["xlstm"], XL_ARCH, "column", mesh, spies, XL_CFG,
                                   names=xlstm_names)}


def _port_frontend(ref, out_dir: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
    with _spied() as spies:
        return {name: _port_moe(ref[name], arch, "column", mesh, spies, vocab=True,
                                cache=FRONT_CACHE)
                for name, arch in FRONT_CASES}


def _port_mesh22(ref, out_dir: Path) -> dict:
    """The ``MESH22_CASES`` on (data=2, model=2), each rank its data row's
    batch rows; then qwen3's serving parameters placed so on K/V placed on
    their slots with the rows over "data" (``_slot_split_decode``), and
    replicated through the flash-decoding override (``_flash_serve``);
    the ranks of this rank's model and data groups."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Sharding, make_mesh, place
    from repro_torch.models import from_jax_params, make_model
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    mesh = make_mesh(*MESH22, device="cpu")
    pl = place(mesh)
    rows = slice(pl.di * B // pl.dsz, (pl.di + 1) * B // pl.dsz)
    out = {"model_group": sorted(dist.get_process_group_ranks(pl.model_group)),
           "data_group": sorted(dist.get_process_group_ranks(pl.data_group))}
    with _spied() as spies:
        for name, arch, changes, role, vocab, _ in MESH22_CASES:
            out[name] = _port_moe(ref[name], arch, role, mesh, spies, changes, vocab, rows=rows)
        name, arch, changes, role, vocab, _ = MESH22_CASES[0]
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        model = make_model(cfg, compute_dtype=torch.float32)
        sv = ref[name]["serve"]
        params = from_jax_params(sv["params"], cfg, device="cpu")
        placed = reshard_state(params, unflatten(params, [
            Sharding(mesh, case_names(p, tuple(x.shape), role, vocab))
            for p, x in flatten_with_paths(params)]))
        out["slots"] = _slot_split_decode(model, sv, placed, mesh)
        out["flash"] = _flash_serve(model, sv, params, mesh, spies)
    return out


def _flash_serve(model, sv, params, mesh, spies) -> dict:
    """The serving case with its parameters replicated (plain tensors) on
    caches its prefill writes split (``SplitCaches(mesh)``: K and V on
    their slots over "model", their rows over "data"), decoded through
    the flash-decoding override: the logits, the greedy tokens, the
    caches' placements and the groups of the override's gathers."""
    import torch

    from repro_torch.launch.flash_decode import SplitCaches, make_decode_attention
    from repro_torch.models import shardctx
    from repro_torch.training.tree import flatten_with_paths

    rules = {"cache_split": SplitCaches(mesh), "decode_attention": make_decode_attention(mesh)}
    toks = torch.from_numpy(sv["tokens"]).long()
    spies["gather_cat"].clear()
    with torch.no_grad(), shardctx.rules(rules):
        logits, caches = model.prefill(params, {"tokens": toks}, MP_CACHE)
        got, new = [logits.numpy()], []
        for i in range(MP_DECODE):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            new.append(tok.numpy())
            logits, caches = model.decode_step(params, tok, caches,
                                               torch.full((2,), MP_PROMPT + i, dtype=torch.int32))
            got.append(logits.numpy())
    return dict(logits=got, greedy=np.concatenate(new, axis=1), gathers=list(spies["gather_cat"]),
                cache={p: (tuple(x.to_local().shape), str(tuple(x.placements)))
                       for p, x in flatten_with_paths(caches)})


def _port_vocab(ref, out_dir: Path) -> dict:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MP_MESHES["dm"], device="cpu")
    with _spied() as spies:
        return {name: _port_moe(ref[name], arch, role, mesh, spies, changes, vocab=True)
                for name, arch, changes, role in VOCAB_CASES}


def _slot_split_decode(model, sv, placed, mesh, prompt: int = MP_PROMPT,
                       cache: int = MP_CACHE) -> dict:
    """The serving case's prefill (``prompt`` tokens into ``cache`` slots)
    under partitioned attention, its K and V then placed on their slots
    over "model" (flash-decoding's placement; any RG-LRU state whole), and
    the greedy decode steps on them beside the same steps on the caches
    as the prefill held them (K and V on their heads, or whole for MQA;
    the states on their width): each step's logits and placements, the
    caches after the steps (whole) and the collectives of the slot
    route."""
    import torch

    from repro_torch.launch.flash_decode import SplitCaches
    from repro_torch.models import shardctx
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, tree_map

    heads, slots = SplitCaches(mesh, model, placed), SplitCaches(mesh, model, placed)
    on_slots = SplitCaches(mesh).shardings(model, 2, cache)
    toks = torch.from_numpy(sv["tokens"]).long()
    out = dict(logits=[], placements=[], greedy=[])
    with torch.no_grad():
        with shardctx.rules({"cache_split": heads}):
            logits, held = model.prefill(placed, {"tokens": toks}, cache)
        moved = reshard_state(tree_map(lambda t: t.full_tensor(), held), on_slots)
        want = {p: str(tuple(x.placements)) for p, x in flatten_with_paths(moved)}
        for i in range(MP_DECODE):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out["greedy"].append(tok.numpy())
            pos = torch.full((2,), prompt + i, dtype=torch.int32)
            with shardctx.rules({"cache_split": heads}):
                logits, held = model.decode_step(placed, tok, held, pos)
            with shardctx.rules({"cache_split": slots}):
                got, moved = model.decode_step(placed, tok, moved, pos)
            out["logits"].append(got.numpy())
            out["same_logits"] = out.get("same_logits", True) and torch.equal(got, logits)
            out["placements"].append({p: str(tuple(x.placements)) == want[p]
                                      for p, x in flatten_with_paths(moved)})
    out.update(greedy=np.concatenate(out["greedy"], axis=1), kinds=dict(slots.parallel.kinds),
               held={p: x.full_tensor().numpy() for p, x in flatten_with_paths(held)},
               moved={p: x.full_tensor().numpy() for p, x in flatten_with_paths(moved)})
    return out


def _port_moe(r, arch: str, role: str, mesh, spies, changes=None, vocab: bool = False, *,
              names=None, seq: int = T, prompt: int = MP_PROMPT, cache: int = MP_CACHE,
              rows=None) -> dict:
    """An MoE case of ``_port_megatron`` on ``mesh`` (data=1, model=2), as
    ``_reference_moe`` runs it (a ``VOCAB_CASES`` case with ``vocab``; with
    ``names``, placed by it; batches of ``seq`` tokens, a prompt of
    ``prompt`` tokens into ``cache`` slots; with ``rows``, each rank
    stepping its rows of the batch): two placed steps (losses, collectives
    by kind and by group, the heads each K3 and chunked attention call got,
    the RG-LRU's channels, the logits each loss call got, the first step's
    gradient before and after its reduction, the leaves summed over
    "model", the leaves gathered and each rank's state bytes, the final
    state; without ``rows``, the first step's MoE routings and a plain
    forward's on the same parameters and batch), then serving (logits,
    greedy tokens, the families, the model group's collectives, the
    attention heads and RG-LRU channels computed, each cache leaf's local
    block and its local and whole bytes)."""
    import dataclasses
    from collections import Counter

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.flash_decode import SplitCaches
    from repro_torch.launch.mesh import Sharding
    from repro_torch.models import from_jax_params, make_model, shardctx
    from repro_torch.training import make_train_step
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    cfg = dataclasses.replace(get_config(arch).reduced(), **(changes or {}))
    model = make_model(cfg, compute_dtype=torch.float32)
    rule = names or (lambda path, shape: case_names(path, shape, role, vocab))

    def specs(tree):
        return unflatten(tree, [Sharding(mesh, rule(p, tuple(x.shape)))
                                for p, x in flatten_with_paths(tree)])

    _, _, tcfg, state = _setup(r, arch, 1, False, cfg)
    placed = reshard_state(state, specs(state))
    step = make_train_step(model, tcfg)
    for v in spies.values():
        v.clear()
    bs = case_batches(cfg, seq)
    take = (lambda v: v) if rows is None else (lambda v: v[rows])
    losses, calls, routes, groups = [], [], [], []
    for b in bs:
        n = len(spies["coll"])
        placed, m = step(placed, {k: torch.from_numpy(take(v)) for k, v in b.items()})
        losses.append(float(m["loss"]))
        calls.append({k: int(v) for k, v in m.items() if k.startswith("collectives")})
        groups.append(dict(Counter(spies["coll"][n:])))
        routes.append(list(spies["routes"]))
        spies["routes"].clear()
    paths = [p for p, _ in flatten_with_paths(placed["params"])]
    out = dict(losses=losses, calls=calls, groups=groups, k3_heads=sorted(set(spies["heads"])),
               ce=sorted(set(spies["ce"])), attn=sorted(set(spies["attn"])),
               lru=sorted(set(spies["lru"])), xlstm=sorted(set(spies["xlstm"])),
               gathered=list(spies["gathered"]),
               partial=[paths[i] for i in (spies["partial"] or [[]])[0]],
               reduce_groups=[sorted(set(c)) for c in spies["reduce_groups"][:len(paths)]],
               grad={p: g.numpy() for p, g in zip(paths, spies["grads"][0])},
               reduced={p: g.numpy() for p, g in zip(paths, spies["reduced"][0])},
               bytes={p: x.to_local().numel() * x.element_size()
                      for p, x in flatten_with_paths(placed)},
               state={p: x.full_tensor().numpy() for p, x in flatten_with_paths(placed)})
    out["routes"] = routes[0]
    if rows is None:
        with torch.no_grad():
            model.loss(from_jax_params(r["params"], cfg, device="cpu"),
                       {k: torch.from_numpy(v) for k, v in bs[0].items()})
        out["plain_routes"] = list(spies["routes"])
    sv = r["serve"]
    params = from_jax_params(sv["params"], cfg, device="cpu")
    placed = reshard_state(params, specs(params))
    split = SplitCaches(mesh, model, placed)
    inputs = {k: torch.from_numpy(v) for k, v in sv["inputs"].items()}
    for key in ("heads", "attn", "lru", "xlstm"):
        spies[key].clear()
    if cfg.modality == "audio":
        # an encoder's forward: each partitioned leaf's block, every other
        # leaf whole, under the rule SplitCaches made with them
        local, rules = split.params(model, placed)
        with torch.no_grad(), shardctx.rules(rules):
            logits = model.forward_logits(local, inputs)
        out["serve"] = dict(logits=[logits.numpy()], k3_heads=sorted(set(spies["heads"])),
                            kinds=dict(split.parallel.kinds),
                            families=sorted(split.parallel.families))
        return out
    inputs["tokens"] = inputs["tokens"].long()
    start = first_position(cfg, inputs)
    with torch.no_grad(), shardctx.rules({"cache_split": split}):
        logits, caches = model.prefill(placed, inputs, cache)
        k3_heads = sorted(set(spies["heads"]))
        got, new = [logits.numpy()], []
        for i in range(MP_DECODE):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            new.append(tok.numpy())
            logits, caches = model.decode_step(placed, tok, caches,
                                               torch.full((2,), start + i, dtype=torch.int32))
            got.append(logits.numpy())
    out["serve"] = dict(
        logits=got, greedy=np.concatenate(new, axis=1), k3_heads=k3_heads,
        attn=sorted(set(spies["attn"])), lru=sorted(set(spies["lru"])),
        xlstm=sorted(set(spies["xlstm"])),
        kinds=dict(split.parallel.kinds), families=sorted(split.parallel.families),
        blocks={p: x.to_local().numpy() for p, x in flatten_with_paths(caches)},
        cache={p: (tuple(x.to_local().shape), x.to_local().numel() * x.element_size(),
                   x.numel() * x.element_size(), str(tuple(x.placements)))
               for p, x in flatten_with_paths(caches)})
    return out


def _port_ep(r, attn: bool, mesh) -> dict:
    """An ``MP_EP_CASES`` case of ``_port_megatron``, as ``_reference_ep``
    runs it, under the port's ``make_moe_apply_ep`` override: the losses
    and final state of two placed steps, the serving logits and greedy
    tokens, the families each program partitions, and the expert counts
    of the weights each call of the override got (global weights: E)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.flash_decode import SplitCaches, make_decode_attention
    from repro_torch.launch.mesh import Sharding
    from repro_torch.launch.moe_ep import make_moe_apply_ep
    from repro_torch.models import from_jax_params, make_model, shardctx
    from repro_torch.training import make_train_step
    from repro_torch.training.elastic import reshard_state
    from repro_torch.training.tree import flatten_with_paths, unflatten

    cfg = get_config(MP_EP_ARCH).reduced()
    model = make_model(cfg, compute_dtype=torch.float32)
    ep, experts = make_moe_apply_ep(mesh, cfg), []

    def ep_spy(x, p, *args, **kw):
        experts.append(p["w_gate"].shape[-3])
        return ep(x, p, *args, **kw)

    def specs(tree):
        return unflatten(tree, [Sharding(mesh, ep_names(p, tuple(x.shape), attn))
                                for p, x in flatten_with_paths(tree)])

    _, _, tcfg, state = _setup(r, MP_EP_ARCH, 1, False, cfg)
    placed = reshard_state(state, specs(state))
    step = make_train_step(model, tcfg)
    losses = []
    with shardctx.rules({"moe_apply": ep_spy}):
        for b in batches(cfg.vocab_size):
            placed, m = step(placed, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    out = dict(losses=losses, step_experts=list(experts),
               state={p: x.full_tensor().numpy() for p, x in flatten_with_paths(placed)})
    sv = r["serve"]
    params = from_jax_params(sv["params"], cfg, device="cpu")
    placed = reshard_state(params, specs(params))
    split = SplitCaches(mesh, model, placed)
    toks = torch.from_numpy(sv["tokens"]).long()
    experts.clear()
    # where attention is replicated its K and V are held on their slots,
    # read through the flash-decoding override
    with torch.no_grad(), shardctx.rules({"cache_split": split, "moe_apply": ep_spy,
                                          "decode_attention": make_decode_attention(mesh)}):
        _, rules = split.params(model, placed)
        logits, caches = model.prefill(placed, {"tokens": toks}, MP_CACHE)
        got, new = [logits.numpy()], []
        for i in range(MP_DECODE):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            new.append(tok.numpy())
            logits, caches = model.decode_step(
                placed, tok, caches, torch.full((2,), MP_EP_PROMPT + i, dtype=torch.int32))
            got.append(logits.numpy())
    mp = rules.get("model_parallel")
    out["serve"] = dict(logits=got, greedy=np.concatenate(new, axis=1),
                        experts=list(experts), families=sorted(split.parallel.families),
                        ep_families=sorted(mp.families) if mp is not None else [])
    return out


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


def port(out_dir: Path, world: int = 2, timeout: float = 150.0, tag: str = "") -> None:
    import multiprocessing as mp

    if tag not in ("_megatron", "_vocab", "_recurrent", "_mesh22", "_xlstm", "_frontend"):
        with open(out_dir / f"reference{tag}.pkl", "rb") as f:
            ref = pickle.load(f)
        if tag == "_placed":
            ref = {"cases": {CASES[0][0]: ref["zero1", CASES[0][0]]}}
        save_world1(ref, out_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank, args=(r, world, str(out_dir), tag))
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
    tag = f"_{sys.argv[3]}" if sys.argv[3:] else ""
    world = 4 if tag == "_mesh22" else 2
    if mode == "reference":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={world}"
        {"": reference, "_placed": reference_placed, "_megatron": reference_megatron,
         "_vocab": reference_vocab, "_recurrent": reference_recurrent,
         "_mesh22": reference_mesh22, "_xlstm": reference_xlstm,
         "_frontend": reference_frontend}[tag](out)
    else:
        port(out, world=world, tag=tag)
