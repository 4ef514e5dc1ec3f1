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
  every step's logits within 1e-4, one all-reduce a block and pass; and
  the same decode steps on K/V placed on their slots over "model"
  (flash-decoding's placement), gathered for each step: the same logits,
  the same rows written, the slot placement kept.

The MoE families on (data=1, model=2) (``ranks.MP_MOE_CASES``): the
reduced granite-moe-1b with its experts split on their expert dim and on
their columns, and the reduced deepseek-v2 (H=4, 8 experts, 2 shared)
with MLA split on its heads, its experts on their expert dim and its
shared experts on their columns. Held, in f32: two steps against the
reference's placed program (losses 1e-5, leaves 1e-4), the first step's
gradient of every leaf (each rank's block of a split one; the whole of a
replicated one, the router's above all) within 1e-5 of the reference's,
the MoE routings (kept slots) those of a plain forward, the collectives
exactly, half the bytes of each split leaf, K3 at each rank's heads, and
greedy serving (logits 1e-4, the same tokens).

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


def test_a_partitioned_layer_reads_a_slot_split_cache(results):
    """K and V placed on their slots over "model" (flash-decoding's
    placement) under partitioned attention, as the reference's jit decodes
    them: each step gathers them, hands each rank its KV heads and keeps
    the new rows where their slots are held. The reference's logits within
    1e-4 and its greedy tokens; the caches after the steps within 1e-4 of
    the reference's, and the logits and every row written those of the
    caches held on their heads, bit for bit; the slot placement kept
    after every step; per step one all-gather of the new rows a cache leaf
    (K and V of each block of the pattern, stacked over the tiles) beside
    the row products' all-reduces."""
    ref, port = results
    for got in port:
        sv = got["serve"]["slots"]
        for step, logits in enumerate(sv["logits"]):
            np.testing.assert_allclose(logits, ref["serve"]["logits"][step + 1], atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], ref["serve"]["greedy"])
        assert sv["same_logits"]
        assert set(sv["moved"]) == set(ref["serve"]["caches"])
        for path, x in sv["held"].items():
            np.testing.assert_allclose(sv["moved"][path], ref["serve"]["caches"][path],
                                       atol=1e-4, err_msg=path)
            np.testing.assert_array_equal(sv["moved"][path], x, err_msg=path)
        assert len(sv["placements"]) == ranks.MP_DECODE
        assert all(all(kept.values()) for kept in sv["placements"])
        assert sv["kinds"] == {"all_reduce": ranks.MP_DECODE * CFG.n_layers * 2,
                               "all_gather": ranks.MP_DECODE * len(CFG.block_pattern) * 2}


# -- the MoE families: granite-moe-1b (both expert roles) and deepseek-v2 ----

MOE = [c[0] for c in ranks.MP_MOE_CASES]
MOE_ARCH = {name: arch for name, arch, _ in ranks.MP_MOE_CASES}
MOE_ROLE = {name: role for name, _, role in ranks.MP_MOE_CASES}


def _moe_cfg(name):
    return get_config(MOE_ARCH[name]).reduced()


def _split_dim(name, path, shape):
    """The dim of a parameter split over "model" in case ``name``, or None."""
    spec = ranks.megatron_names("dm", path, shape, MOE_ROLE[name])
    return spec.index("model") if "model" in spec else None


def _block(name, path, w, rank):
    d = _split_dim(name, path, w.shape)
    if d is None:
        return w
    n = w.shape[d] // WORLD
    return np.take(w, range(rank * n, (rank + 1) * n), axis=d)


@pytest.mark.parametrize("name", MOE)
def test_moe_partitioned_steps_match_the_reference(results, name):
    ref, port = results
    want = ref[name]
    for got in port:
        got = got[name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", MOE)
def test_moe_ranks_agree(results, name):
    _, port = results
    a, b = (p[name] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


@pytest.mark.parametrize("name", MOE)
def test_moe_gradients_are_the_references(results, name):
    """The first step's gradient as each rank reduces it: a split leaf's
    the rank's block of the reference's, every replicated leaf (the
    router, MLA's down-projections and norms, the embedding) whole, each
    within 1e-5."""
    ref, port = results
    want = ref[name]["grad"]
    routers = 0
    for rank, got in enumerate(port):
        got = got[name]["grad"]
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], _block(name, path, w, rank), atol=1e-5,
                                       err_msg=path)
            routers += path.endswith("['router']") and got[path].shape == w.shape
    assert routers == WORLD


@pytest.mark.parametrize("name", MOE)
def test_moe_kept_slots_are_the_plain_forwards(results, name):
    """Every rank routes the same tokens alike: the first step's kept
    choices and their slots, layer by layer, those of a forward of the
    same parameters and batch with no mesh."""
    _, port = results
    for got in port:
        got = got[name]
        assert len(got["routes"]) == _moe_cfg(name).n_layers == len(got["plain_routes"])
        for (keep, dest), (pk, pd) in zip(got["routes"], got["plain_routes"]):
            np.testing.assert_array_equal(keep, pk)
            np.testing.assert_array_equal(dest, pd)


@pytest.mark.parametrize("name", MOE)
def test_moe_step_collectives(results, name):
    """No gather, no reduce-scatter; all-reduces: one a gradient leaf, the
    loss's 3, the MoE aux loss's 3 a layer (f_e; m_e and its backward),
    the global norm's one over "model"; then the model group's, per layer:
    GQA 1 after wo and 1 before its column products in the backward; MLA 1
    after wo and 3 in the backward (the q latent, c_kv, k_rope); the MoE 1
    after the combine and 2 in the backward (the tokens, the combine
    weights)."""
    ref, port = results
    cfg = _moe_cfg(name)
    n_leaves = sum(1 for p in ref[name]["state"] if p.startswith("['params']"))
    per_layer = 3 + (4 if cfg.attention == "mla" else 2)
    want = n_leaves + 3 + 3 * cfg.n_layers + 1 + per_layer * cfg.n_layers
    for got in port:
        for c in got[name]["calls"]:
            assert c == {"collectives": want, "collectives.all_reduce": want,
                         "collectives.reduce_scatter": 0, "collectives.all_gather": 0}


@pytest.mark.parametrize("name", MOE)
def test_moe_split_leaves_take_half_the_bytes(results, name):
    """Each split leaf's gradient, parameter and moments: half the whole's
    bytes on every rank; every other leaf whole. The split leaves are
    every role's: the experts, the shared experts, and GQA's or MLA's."""
    ref, port = results
    state = ref[name]["state"]
    want_split = 10 if _moe_cfg(name).attention == "mla" else 7
    for got in port:
        got = got[name]
        split = 0
        for path, g in got["grad"].items():
            full = state["['params']" + path]
            half = _split_dim(name, path, full.shape) is not None
            assert g.nbytes * (2 if half else 1) == full.nbytes, path
            split += half
        assert split == want_split * len({p.split("]")[1] for p in got["grad"]
                                          if p.startswith("['blocks']")})
        for path, n in got["bytes"].items():
            half = _split_dim(name, path, state[path].shape) is not None
            assert n * (2 if half else 1) == state[path].nbytes, path


@pytest.mark.parametrize("name", MOE)
def test_moe_k3_gets_each_ranks_heads(results, name):
    _, port = results
    cfg = _moe_cfg(name)
    kv = cfg.n_heads if cfg.attention == "mla" else cfg.n_kv_heads
    for got in port:
        assert got[name]["k3_heads"] == [(cfg.n_heads // 2, kv // 2)]
        assert got[name]["serve"]["k3_heads"] == [(cfg.n_heads // 2, kv // 2)]


@pytest.mark.parametrize("name", MOE)
def test_moe_serving_matches_the_reference(results, name):
    """Prefill and 4 greedy decode steps (the MoE drop-free there) with the
    parameters so placed: logits within 1e-4 of the reference's, the same
    greedy tokens; one all-reduce after each attention and each MoE block
    a pass; GQA's K and V held on their heads (half each), MLA's latent
    whole on every rank."""
    ref, port = results
    cfg = _moe_cfg(name)
    want = ref[name]["serve"]
    for got in port:
        sv = got[name]["serve"]
        for a, b in zip(sv["logits"], want["logits"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        mla = cfg.attention == "mla"
        assert sv["families"] == (["mla", "moe"] if mla else ["attn", "moe"])
        assert sv["kinds"] == {"all_reduce": (1 + ranks.MP_DECODE) * cfg.n_layers * 2}
        assert sv["cache"]
        for path, (_, local, whole, placements) in sv["cache"].items():
            assert local * (1 if mla else 2) == whole, path
            assert ("Shard" not in placements) if mla else ("Shard(dim=3)" in placements), path


# -- the MoE under the launcher's expert-parallel override -------------------

EP = [c[0] for c in ranks.MP_EP_CASES]
EP_ATTN = dict(ranks.MP_EP_CASES)


@pytest.mark.parametrize("name", EP)
def test_the_expert_parallel_override_takes_whole_experts(results, name):
    """Granite's experts placed on their expert dim, attention split or
    replicated, stepped and served under ``make_moe_apply_ep`` as the
    reference's jit under its own override: the losses within 1e-5 and
    every leaf within 1e-4, the logits within 1e-4 and the same greedy
    tokens. Every call of the override (the steps' and the prefill's) gets
    all E experts, and the MoE takes the gathered route: only GQA is
    partitioned, where it is split."""
    ref, port = results
    want = ref[name]
    E = get_config(ranks.MP_EP_ARCH).reduced().n_experts
    fams = ["attn"] if EP_ATTN[name] else []
    for got in port:
        got = got[name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)
        sv = got["serve"]
        for a, b in zip(sv["logits"], want["serve"]["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["serve"]["greedy"])
        assert got["step_experts"] and set(got["step_experts"]) == {E}
        assert sv["experts"] and set(sv["experts"]) == {E}
        assert sv["families"] == sorted(fams + ["moe"]) and sv["ep_families"] == fams


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


def _experts(path, shape):
    """Megatron's placement with the routed experts on their expert dim."""
    return ranks.megatron_names("dm", path, shape, "expert")


def _mixed(path, shape):
    """The experts' w_gate on its expert dim, w_up and w_down on columns:
    no role of the whole group."""
    if path.endswith("['ffn']['w_gate']") and len(shape) == 4:
        return _experts(path, shape)
    return _megatron(path, shape)


def _router_split(path, shape):
    """The experts on their expert dim and the router split too."""
    if path.endswith("['router']"):
        return _last(path, shape)
    return _experts(path, shape)


def _no_shared(path, shape):
    """The shared experts left replicated: their MoE group is not whole."""
    return () if "['shared']" in path else _experts(path, shape)


CLASSIFY = {  # name: (arch, config changes, model ranks, spec rule, families)
    "megatron": ("qwen3-1.7b", ranks.MP_CFG, 2, _megatron, {"attn", "mlp"}),
    "heads_do_not_divide": ("qwen3-1.7b", ranks.MP_CFG, 4, _megatron, {"mlp"}),
    "last_dim_everywhere": ("qwen3-1.7b", ranks.MP_CFG, 2, _last, set()),
    "moe_experts": ("granite-moe-1b-a400m", {}, 2, _megatron, {"attn", "moe"}),
    "mla": ("deepseek-v2-236b", {}, 2, _megatron, {"mla", "moe"}),
    "moe_expert_role": ("granite-moe-1b-a400m", {}, 2, _experts, {"attn", "moe"}),
    "mla_expert_role": ("deepseek-v2-236b", {}, 2, _experts, {"mla", "moe"}),
    # 6 experts do not divide over 4 ranks: the experts stay gathered
    "experts_do_not_divide": ("granite-moe-1b-a400m", {"n_experts": 6}, 4, _experts, {"attn"}),
    "experts_mixed_roles": ("granite-moe-1b-a400m", {}, 2, _mixed, {"attn"}),
    "router_split": ("granite-moe-1b-a400m", {}, 2, _router_split, {"attn"}),
    "shared_not_split": ("deepseek-v2-236b", {}, 2, _no_shared, {"mla"}),
    "mla_heads_do_not_divide": ("deepseek-v2-236b", {}, 8, _experts, {"moe"}),
    # its local attention has one KV head, which 2 ranks cannot split
    "recurrent_one_kv_head": ("recurrentgemma-2b", {}, 2, _megatron, {"mlp"}),
}


@pytest.mark.parametrize("name", CLASSIFY)
def test_which_placements_partition(name):
    """GQA, MLA, the dense MLP and the MoE are partitioned where every
    group of the family is whole in its roles (column/row; the routed
    experts also all on their expert dim), every other leaf of it
    replicated and, for attention, "model" divides the heads; MoE experts
    in mixed roles, a split router, an MoE whose shared experts are not
    split and a wo split on its last dim are not. A leaf's role needs it
    split evenly and replicated over every other mesh dim."""
    arch, changes, m, rule, want = CLASSIFY[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    families, paths = partitioned_leaves(cfg, _mesh(m), _items(cfg, rule))
    assert set(families) == want
    assert all(p.endswith(PARTED) for p in paths)
    assert bool(paths) == bool(want)


def test_the_expert_parallel_override_keeps_the_moe_gathered():
    """The families named ``gathered`` (the train step's and serving's
    under the launcher's ``moe_apply`` override, which takes the experts'
    global weights) are never partitioned; the others still are."""
    cfg = get_config("deepseek-v2-236b").reduced()
    items = _items(cfg, _experts)
    families, paths = partitioned_leaves(cfg, _mesh(2), items, gathered=("moe",))
    assert set(families) == {"mla"}
    assert paths and not any("['ffn']" in p for p in paths)


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
    # an MoE layer's (E, d, f) experts in a stacked tile: on their columns,
    # or on their expert dim, and only with the data dim replicated
    up = "['blocks']['g0']['ffn']['w_up']"
    assert partition_role(up, (2, 8, 64, 32), (Replicate(), Shard(3)), mesh) == "column"
    assert partition_role(up, (2, 8, 64, 32), (Replicate(), Shard(1)), mesh) == "expert"
    assert partition_role(up, (2, 8, 64, 32), (Shard(3), Shard(1)), mesh) is None
    assert partition_role(up, (2, 8, 64, 32), (Replicate(), Shard(2)), mesh) is None
    assert partition_role("['blocks']['g0']['ffn']['w_down']", (2, 8, 32, 64),
                          (Replicate(), Shard(1)), mesh) == "expert"
    # E = 7 does not split evenly over 2 ranks
    assert partition_role(up, (2, 7, 64, 32), (Replicate(), Shard(1)), mesh) is None
    # a shared expert or a dense MLP has no expert dim
    assert partition_role("['blocks']['g0']['ffn']['shared']['w_up']", (2, 64, 32),
                          (Replicate(), Shard(2)), mesh) == "column"
    assert partition_role("['blocks']['g0']['ffn']['shared']['w_up']", (2, 64, 32),
                          (Replicate(), Shard(0)), mesh) is None
