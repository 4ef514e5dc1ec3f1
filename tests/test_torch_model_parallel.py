"""Partitioned compute over ``model`` (Megatron's column/row split): the
port on 2 gloo ranks against the reference's placed ``jax.jit`` programs
on 2 forced host devices, on the CPU.

``tests/torch_train_ranks.py ... megatron`` runs each side once as a
script. The reduced qwen3 with G = 2 (H=4, KV=2) is placed as Megatron
places it (``ranks.megatron_names``): wq, wk, wv, w_gate and w_up split
over "model" on their output dim, wo and w_down on their input dim, their
moments and residuals alike, every other leaf replicated (on the mesh of
"model" alone the tied embedding is split too, and takes the gathered
route). The reference's GSPMD partitions the same products. Held, in f32:

* two train steps (microbatches 1, and 2 with int8 compression) on
  (data=1, model=2) and on a mesh of "model" alone, (2,): losses within
  1e-5 and every leaf within 1e-4 of the reference's placed program, with
  ``tests/test_torch_train_placed.py``'s rules for the elements where
  that program leaves its own single-device step and for the residuals;
  the two ranks identical;
* no partitioned leaf is all-gathered, and the collectives a step are
  exactly those predicted: per layer and microbatch one all-reduce after
  each row product (wo, w_down) and one in the backward before each
  block's column products, one packed all-reduce of the q and k norms'
  gradients, the data group's as in the gathered route;
* each rank's K3 op gets H/2 query heads and KV/2 key-value heads, in the
  train step and in the prefill;
* each rank's gradient, parameter, moments and residual of a partitioned
  leaf, and its K/V cache, take exactly half the bytes of the whole;
* prefill and 4 greedy decode steps on K/V caches split on their heads
  (``SplitCaches(mesh, model, params)``): the reference's greedy tokens,
  every step's logits within 1e-4, one all-reduce a block and pass.

The rule that names the layout (``launch.mesh.partitioned_leaves``) is
also held here in one process, on placements that do and do not
partition.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import torch_train_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.launch.mesh import partition_role, partitioned_leaves
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_train_ranks.py")
WORLD = 2
PAIRS = [(m, c[0]) for m in ranks.MP_MESHES for c in ranks.MP_CASES]
CFG = dataclasses.replace(get_config(ranks.MP_ARCH).reduced(), **ranks.MP_CFG)
PARTED = ranks.COLUMN + ranks.ROW


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "megatron"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("megatron")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_megatron.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_megatron_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


def _parted(path: str) -> bool:
    return path.endswith(PARTED)


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_partitioned_steps_match_the_reference(results, mesh, case):
    ref, port = results
    want = ref[mesh, case]
    single = ref[want["single"]]
    for got in port:
        got = got[mesh, case]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            g = got["state"][path]
            off = np.abs(g - w) > 1e-4
            if path.startswith("['compress']"):
                assert off.sum() <= w.size // 1000, path
                assert np.all(np.abs(g - w)[off] <= 2 * np.abs(w).max() + 1e-4), path
                continue
            assert np.all(np.abs(single[path] - w)[off] > 1e-4), path
            np.testing.assert_allclose(g[off], single[path][off], atol=1e-4, err_msg=path)


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_ranks_agree(results, mesh, case):
    _, port = results
    a, b = (p[mesh, case] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_partitioned_step_collectives(results, mesh, case):
    """No all-gather but the gathered embedding's on the mesh of "model"
    alone, no reduce-scatter; all-reduces: one a gradient leaf (the data
    group's average), the loss's 3 a microbatch, the global norm's one
    (over "model", where leaves are split), with compression the scale's
    maximum and the error's sums; then the model group's: per layer and
    microbatch 2 after the row products and 2 in the backward, and the
    norms' packed sum."""
    ref, port = results
    _, _, mb, comp, _ = next(c for c in ranks.MP_CASES if c[0] == case)
    n_leaves = sum(1 for p in ref[mesh, case]["state"] if p.startswith("['params']"))
    layers = CFG.n_layers
    for got in port:
        for c in got[mesh, case]["calls"]:
            assert c["collectives.all_gather"] == (1 if mesh == "m" else 0)
            assert c["collectives.reduce_scatter"] == 0
            assert c["collectives.all_reduce"] == (n_leaves + 3 * mb + 1 + (2 if comp else 0)
                                                   + 4 * layers * mb + 1)
            assert c["collectives"] == sum(v for k, v in c.items() if k != "collectives")


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_k3_gets_each_ranks_heads_in_the_step(results, mesh, case):
    _, port = results
    for got in port:
        assert got[mesh, case]["k3_heads"] == [(CFG.n_heads // 2, CFG.n_kv_heads // 2)]


@pytest.mark.parametrize("mesh,case", PAIRS)
def test_partitioned_leaves_take_half_the_bytes(results, mesh, case):
    """A partitioned leaf's gradient (as the step reduces it), parameter,
    moments and residual: half the whole's bytes on every rank; every
    other gradient whole (the gathered embedding's too)."""
    ref, port = results
    whole = {p: w.size * w.itemsize for p, w in ref[mesh, case]["state"].items()}
    for got in port:
        got = got[mesh, case]
        halved = 0
        for path, n in got["grad_bytes"].items():
            full = whole["['params']" + path]
            assert n * (2 if _parted(path) else 1) == full, path
            halved += _parted(path)
        assert halved == 7 * len([k for k in ref[mesh, case]["state"]
                                  if k.startswith("['params']") and k.endswith("['wq']")])
        for path, n in got["bytes"].items():
            split = _parted(path) or (mesh == "m" and path.endswith("['embed']"))
            assert n * (2 if split else 1) == whole[path], path


@pytest.mark.parametrize("step", range(1 + ranks.MP_DECODE))
def test_head_split_serving_matches_the_reference(results, step):
    """Prefill (step 0) and each greedy decode step: logits within 1e-4 of
    the reference's; the same greedy tokens."""
    ref, port = results
    for got in port:
        np.testing.assert_allclose(got["serve"]["logits"][step], ref["serve"]["logits"][step],
                                   atol=1e-4)
        np.testing.assert_array_equal(got["serve"]["greedy"], ref["serve"]["greedy"])


def test_head_split_cache_takes_half_the_bytes(results):
    _, port = results
    for got in port:
        sv = got["serve"]
        assert sv["families"] == ["attn", "mlp"]
        assert sv["k3_heads"] == [(CFG.n_heads // 2, CFG.n_kv_heads // 2)]
        assert sv["cache"]
        for path, (shape, local, whole, placements) in sv["cache"].items():
            assert 2 * local == whole, path
            assert shape[-2] == CFG.n_kv_heads // 2 and "Shard(dim=3)" in placements, path


def test_serving_collectives(results):
    """One all-reduce after each block's row product a pass (prefill and 4
    decode steps), nothing else: no flash-decode merge, no gather."""
    _, port = results
    for got in port:
        assert got["serve"]["kinds"] == {"all_reduce": (1 + ranks.MP_DECODE) * CFG.n_layers * 2}


def test_a_partitioned_layer_refuses_a_slot_split_cache(results):
    """K and V placed on their slots over "model" (flash-decoding's
    placement) under partitioned attention: the port cannot read them and
    raises, naming the leaf (the reference's jit runs it; ROADMAP Queue 3)."""
    _, port = results
    for got in port:
        msg = got["serve"]["refused"]
        assert msg is not None and "caches['blocks']['g0']['k']" in msg and "KV heads" in msg


# -- the rule that names the layout, in one process --------------------------

def _mesh(model: int, data: int = 1):
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=(data, model))


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(names.index(a)) if a in names else Replicate()
                 for a in ("data", "model"))


def _items(cfg, rule):
    """(path, shape, placements) of the reduced model's parameters, each
    leaf's spec from ``rule(path, shape)``."""
    import torch

    from repro_torch.models import make_model
    from repro_torch.training.tree import flatten_with_paths

    shapes = make_model(cfg).init(torch.Generator().manual_seed(0))
    return [(p, tuple(t.shape), _placements(rule(p, tuple(t.shape))))
            for p, t in flatten_with_paths(shapes)]


def _megatron(path, shape):
    return ranks.megatron_names("dm", path, shape)


def _last(path, shape):
    return (None,) * (len(shape) - 1) + ("model",) if len(shape) else ()


CLASSIFY = {  # name: (arch, config changes, model ranks, spec rule, families)
    "megatron": ("qwen3-1.7b", ranks.MP_CFG, 2, _megatron, {"attn", "mlp"}),
    "heads_do_not_divide": ("qwen3-1.7b", ranks.MP_CFG, 4, _megatron, {"mlp"}),
    "last_dim_everywhere": ("qwen3-1.7b", ranks.MP_CFG, 2, _last, set()),
    "moe_experts": ("granite-moe-1b-a400m", {}, 2, _megatron, {"attn"}),
    "mla": ("deepseek-v2-236b", {}, 2, _megatron, set()),
    # its local attention has one KV head, which 2 ranks cannot split
    "recurrent_one_kv_head": ("recurrentgemma-2b", {}, 2, _megatron, {"mlp"}),
}


@pytest.mark.parametrize("name", CLASSIFY)
def test_which_placements_partition(name):
    """GQA and the dense MLP are partitioned where every group of the
    family is placed column/row and, for attention, "model" divides the
    heads; an MoE layer's experts, MLA and a wo split on its last dim are
    not. A leaf's role needs it replicated over every other mesh dim."""
    arch, changes, m, rule, want = CLASSIFY[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    families, paths = partitioned_leaves(cfg, _mesh(m), _items(cfg, rule))
    assert set(families) == want
    assert all(p.endswith(PARTED) for p in paths)
    assert bool(paths) == bool(want)


def test_a_role_needs_the_other_mesh_dims_replicated():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(2, 2)
    path, shape = "['blocks']['g0']['attn']['wq']", (2, 64, 64)
    assert partition_role(path, shape, (Replicate(), Shard(2)), mesh) == "column"
    assert partition_role(path, shape, (Shard(0), Shard(2)), mesh) is None
    assert partition_role(path, shape, (Replicate(), Shard(1)), mesh) is None
    wo = "['blocks']['g0']['attn']['wo']"
    assert partition_role(wo, shape, (Replicate(), Shard(1)), mesh) == "row"
    assert partition_role("['tail'][0]['ffn']['w_down']", (64, 64),
                          (Replicate(), Shard(0)), mesh) == "row"
    # an MoE layer's (E, d, f) experts in a stacked tile: no role
    assert partition_role("['blocks']['g0']['ffn']['w_up']", (2, 8, 64, 32),
                          (Replicate(), Shard(3)), mesh) is None
