"""recurrentgemma partitioned over ``model``: the RG-LRU on its width and
the local attention's query heads split with its one KV head replicated
(MQA). The port on 2 gloo ranks against the reference's placed
``jax.jit`` programs on 2 forced host devices, on the CPU.

``tests/torch_train_ranks.py ... recurrent`` runs each side once as a
script: the reduced recurrentgemma-2b (H=4, KV=1, W=64, 8 layers: two
tiles of (rglru, rglru, local) and two RG-LRU layers in the tail) on
(data=1, model=2), placed by ``ranks.recurrent_names``: the RG-LRU's wx,
wgate, w_input_gate and w_rec_gate on their columns, w_out on its rows,
log_lambda and the conv on their channels; wq on its columns and wo on its
rows with wk and wv replicated; the MLP Megatron-style and the tied
embedding on its vocabulary. Its sequences (40 tokens) and its prompt (40
tokens into 48 slots) pass the window of 32. The reference's GSPMD
partitions the same products. Held, in f32:

* two train steps: losses within 1e-5 and every leaf and moment within
  1e-4; the first step's gradient of every leaf (each rank's block of a
  split one, wk's and wv's whole: summed over "model") within 1e-5 of
  ``jax.grad`` of the placed loss; the two ranks identical;
* each rank's RG-LRU scans its W/2 channels and its windowed attention
  (K3 in the steps and the prefill) reads H/2 query heads over the one KV
  head, in the steps and in serving; no parameter is gathered; wk and wv
  are the leaves the step sums over "model";
* the collectives a step, predicted: per RG-LRU layer one all-gather of
  the conv output and one reduce-scatter of its gradient;
* the split leaves, their gradients and moments, and the RG-LRU states at
  half their bytes a rank;
* greedy serving (prefill and 4 decode steps): the reference's tokens,
  logits within 1e-4; the states held on their width, whose blocks
  gathered are the reference's caches within 1e-4, and K/V whole.

The rule that names the families (``launch.mesh.partitioned_leaves``) is
held here in one process too, and the model group's differentiable gather
against autograd's.
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
import torch

import torch_train_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.launch.mesh import partition_role, partitioned_leaves
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_train_ranks.py")
WORLD = 2
CFG = dataclasses.replace(get_config(ranks.REC_ARCH).reduced(), **ranks.REC_CFG)
STATES = ("['h']", "['conv']")
# the RG-LRU groups of the tree: the pattern's two (stacked over the
# tiles) and the tail's two layers
RG_GROUPS = CFG.block_pattern.count("rglru") + CFG.block_pattern[
    :CFG.n_layers % len(CFG.block_pattern)].count("rglru")


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "recurrent"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("recurrent")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_recurrent.pkl", "rb") as f:
        ref = pickle.load(f)["recurrent"]
    port = []
    for r in range(WORLD):
        with open(out / f"port_recurrent_{r}.pkl", "rb") as f:
            port.append(pickle.load(f)["recurrent"])
    return ref, port


def _split_dim(path, shape):
    spec = ranks.recurrent_names(path, shape)
    return spec.index("model") if "model" in spec else None


def _block(path, w, rank):
    d = _split_dim(path, w.shape)
    if d is None:
        return w
    n = w.shape[d] // WORLD
    return np.take(w, range(rank * n, (rank + 1) * n), axis=d)


def _layers(kind):
    return sum(1 for i in range(CFG.n_layers)
               if CFG.block_pattern[i % len(CFG.block_pattern)] == kind)


def test_the_config_has_a_tail_and_passes_its_window():
    assert CFG.n_kv_heads == 1 and CFG.n_heads % WORLD == 0 and CFG.lru_width % WORLD == 0
    assert RG_GROUPS == 4 and ranks.REC_SEQ > CFG.window
    assert ranks.REC_PROMPT > CFG.window


def test_steps_match_the_reference(results):
    ref, port = results
    for got in port:
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5)
        assert set(got["state"]) == set(ref["state"])
        for path, w in ref["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)


def test_gradients_are_the_references(results):
    """The first step's gradient as each rank reduces it: a split leaf's
    block of ``jax.grad``'s, every replicated leaf whole; MQA's wk and wv
    (each rank's query heads give a part) summed over "model"."""
    ref, port = results
    want = ref["grad"]
    for rank, got in enumerate(port):
        assert set(got["grad"]) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got["grad"][path], _block(path, w, rank), atol=1e-5,
                                       err_msg=path)
        kv = [p for p in got["grad"] if p.endswith(ranks.MQA_KV)]
        assert kv and sorted(got["partial"]) == sorted(kv)


def test_ranks_agree(results):
    _, port = results
    a, b = port
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


def test_each_rank_computes_its_channels_and_heads(results):
    """Every RG-LRU scan and step runs on W/2 channels and every windowed
    attention call on H/2 query heads over the one KV head, in the steps
    and in serving: the windows of the steps and the prefill through K3
    (``ops.flash_attention``, never the chunked scan), the decode steps'
    through the chunked attention; no parameter gathered whole."""
    _, port = results
    for got in port:
        for part in (got, got["serve"]):
            assert part["lru"] == [CFG.lru_width // WORLD]
            assert part["k3_heads"] == [(CFG.n_heads // WORLD, 1)]
        assert got["attn"] == []
        assert got["serve"]["attn"] == [(CFG.n_heads // WORLD, 1)]
        assert got["gathered"] == []


def test_step_collectives(results):
    """All-reduces: one a gradient leaf, the loss's 3, the global norm's
    one, the packed sum of wk's and wv's gradients, the vocabulary's 4,
    and per layer 2 after its mixer's and its MLP's row products and 2 in
    the backward; per RG-LRU layer one all-gather of the conv output and
    one reduce-scatter of its gradient."""
    ref, port = results
    n_leaves = sum(1 for p in ref["state"] if p.startswith("['params']"))
    rg = _layers("rglru")
    want = n_leaves + 3 + 1 + 1 + 4 + 4 * CFG.n_layers
    for got in port:
        for c in got["calls"]:
            assert c == {"collectives": want + 2 * rg, "collectives.all_reduce": want,
                         "collectives.reduce_scatter": rg, "collectives.all_gather": rg}


def test_split_leaves_take_half_the_bytes(results):
    """Each split leaf's gradient, parameter and moments: half the whole's
    bytes on every rank, every other leaf whole; per RG-LRU group all 8 of
    its leaves are split, per attention group wq and wo."""
    ref, port = results
    state = ref["state"]
    for got in port:
        split = {"core": 0, "attn": 0}
        for path, g in got["grad"].items():
            full = state["['params']" + path]
            half = _split_dim(path, full.shape) is not None
            assert g.nbytes * (2 if half else 1) == full.nbytes, path
            for k in split:
                split[k] += half and f"['{k}']" in path
        assert split == {"core": 8 * RG_GROUPS, "attn": 2}
        for path, n in got["bytes"].items():
            half = _split_dim(path, state[path].shape) is not None
            assert n * (2 if half else 1) == state[path].nbytes, path


def test_serving_matches_the_reference(results):
    """Prefill (40 tokens, past the window) and 4 greedy decode steps:
    logits within 1e-4, the same greedy tokens; per pass one all-reduce
    after each block's mixer and MLP, one for the lookup, one all-gather a
    RG-LRU layer and one of the logits."""
    ref, port = results
    want = ref["serve"]
    passes = 1 + ranks.MP_DECODE
    for got in port:
        sv = got["serve"]
        for a, b in zip(sv["logits"], want["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["families"] == ["attn", "mlp", "rglru", "vocab"]
        assert sv["kinds"] == {"all_reduce": passes * (2 * CFG.n_layers + 1),
                               "all_gather": passes * (_layers("rglru") + 1)}


def test_states_are_held_on_their_width(results):
    """Each RG-LRU state (h, conv) is split on its last dim: half the bytes
    a rank, and the two ranks' blocks side by side are the reference's
    caches after the decode steps within 1e-4; MQA's K and V are whole on
    every rank and the reference's within 1e-4."""
    ref, port = results
    want = ref["serve"]["caches"]
    blocks = [got["serve"]["blocks"] for got in port]
    assert set(blocks[0]) == set(want)
    n_states = 0
    for path, w in want.items():
        if path.endswith(STATES):
            got = np.concatenate([b[path] for b in blocks], axis=-1)
            n_states += 1
            for r in range(WORLD):
                shape, local, whole, placements = port[r]["serve"]["cache"][path]
                assert 2 * local == whole and f"Shard(dim={w.ndim - 1})" in placements, path
        else:
            got = blocks[0][path]
            np.testing.assert_array_equal(blocks[1][path], got, err_msg=path)
            assert "Shard" not in port[0]["serve"]["cache"][path][3], path
        np.testing.assert_allclose(got, w, atol=1e-4, err_msg=path)
    assert n_states == 2 * RG_GROUPS


def test_states_placed_otherwise_are_gathered_for_a_step(results):
    """The caches placed as flash-decoding places them (K and V on their
    slots over "model", every state whole) under the partitioned layers:
    each step gathers them, hands each rank its channels of each state and
    all-gathers the new state at the step's end. The logits of the caches
    the prefill held (states on their width) bit for bit, the reference's
    within 1e-4 and its greedy tokens; the caches after the steps the
    reference's within 1e-4 and equal to the held ones; the placement
    kept. Per step, besides the serving pass's collectives, one all-gather
    a state leaf (h and conv of each RG-LRU group)."""
    ref, port = results
    want = ref["serve"]
    for got in port:
        sv = got["slots"]
        for step, logits in enumerate(sv["logits"]):
            np.testing.assert_allclose(logits, want["logits"][step + 1], atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["same_logits"]
        for path, x in sv["held"].items():
            np.testing.assert_allclose(sv["moved"][path], want["caches"][path], atol=1e-4,
                                       err_msg=path)
            np.testing.assert_array_equal(sv["moved"][path], x, err_msg=path)
        assert len(sv["placements"]) == ranks.MP_DECODE
        assert all(all(kept.values()) for kept in sv["placements"])
        assert sv["kinds"] == {
            "all_reduce": ranks.MP_DECODE * (2 * CFG.n_layers + 1),
            "all_gather": ranks.MP_DECODE * (_layers("rglru") + 1 + 2 * RG_GROUPS)}


# -- the rule that names the families, in one process --------------------------

def _mesh(model: int, data: int = 1):
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=(data, model))


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(names.index(a)) if a in names else Replicate()
                 for a in ("data", "model"))


def _items(cfg, rule):
    from repro_torch.models import make_model
    from repro_torch.training.tree import flatten_with_paths

    shapes = make_model(cfg).init(torch.Generator().manual_seed(0))
    return [(p, tuple(t.shape), _placements(rule(p, tuple(t.shape))))
            for p, t in flatten_with_paths(shapes)]


def _megatron(path, shape):
    return ranks.megatron_names("dm", path, shape)


def _rglru(path, shape):
    """The RG-LRU on its width, everything else as Megatron places it (wk
    and wv split inside the one KV head: attention stays gathered)."""
    if path.endswith(ranks.RGLRU_LAST + ranks.RGLRU_ROW):
        return ranks.recurrent_names(path, shape)
    return _megatron(path, shape)


def _mqa(path, shape):
    """``ranks.recurrent_names`` without the vocabulary."""
    if path.endswith(("['embed']", "['lm_head']")):
        return ()
    return ranks.recurrent_names(path, shape)


def _conv_alone(path, shape):
    """Only the conv split on its channels; the rest of the RG-LRU
    replicated."""
    if path.endswith(("['core']['conv']['w']", "['core']['conv']['b']")):
        return ranks.recurrent_names(path, shape)
    return _megatron(path, shape)


def _out_on_columns(path, shape):
    """w_out split on its last dim (d): not its role."""
    if path.endswith(ranks.RGLRU_ROW):
        return (None,) * (len(shape) - 1) + ("model",)
    return _mqa(path, shape)


CLASSIFY = {  # name: (config changes, model ranks, spec rule, families)
    "rglru": ({}, 2, _rglru, {"mlp", "rglru"}),
    "mqa_kv_replicated": ({}, 2, _mqa, {"attn", "mlp", "rglru"}),
    # two KV heads replicated: not MQA, and the heads would pair wrongly
    "mqa_wide_kv_replicated": ({"n_kv_heads": 2}, 2, _mqa, {"mlp", "rglru"}),
    # W = 66 does not split over 4 ranks; H = 4 and d_ff = 128 do
    "lru_width_does_not_divide": ({"lru_width": 66}, 4, _mqa, {"attn", "mlp"}),
    "conv_split_alone": ({}, 2, _conv_alone, {"mlp"}),
    "w_out_on_its_columns": ({}, 2, _out_on_columns, {"attn", "mlp"}),
    # H = 4 does not split over 8 ranks: attention stays gathered
    "heads_do_not_divide": ({"d_ff": 256}, 8, _mqa, {"mlp", "rglru"}),
}


@pytest.mark.parametrize("name", CLASSIFY)
def test_which_placements_partition_the_recurrent_blocks(name):
    """"rglru" is partitioned where every RG-LRU group is whole in its
    roles (its products on their columns, w_out on its rows, log_lambda
    and the conv on their channels) and ``model`` divides its width;
    attention's MQA choice (wq, wo split, wk and wv replicated) where
    ``model`` divides the query heads and there is one KV head. A wider KV
    replicated, the conv split alone, w_out on its columns stay gathered.
    The split leaves are the families' exactly."""
    changes, m, rule, want = CLASSIFY[name]
    cfg = dataclasses.replace(CFG, **changes)
    families, paths = partitioned_leaves(cfg, _mesh(m), _items(cfg, rule))
    assert set(families) == want
    core = {p for p in paths if "['core']" in p}
    attn = {p for p in paths if "['attn']" in p}
    assert len(core) == (8 * RG_GROUPS if "rglru" in want else 0)
    assert attn == ({"['blocks']['g2']['attn']['wq']", "['blocks']['g2']['attn']['wo']"}
                    if "attn" in want else set())


def test_the_width_role():
    """A per-channel leaf's role from its placement: its last dim split,
    with or without a state's prefix, in a tile or in the tail; another
    dim, a data dim split too, or a width that does not divide: none."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(2, 2)
    last = (Replicate(), Shard(1))
    for prefix in ("", "['params']", "['opt']['mu']"):
        assert partition_role(prefix + "['blocks']['g0']['core']['log_lambda']", (2, 64),
                              last, mesh) == "width"
        assert partition_role(prefix + "['tail'][0]['core']['conv']['b']", (64,),
                              (Replicate(), Shard(0)), mesh) == "width"
    w = "['blocks']['g0']['core']['conv']['w']"
    assert partition_role(w, (2, 4, 64), (Replicate(), Shard(2)), mesh) == "width"
    assert partition_role(w, (2, 4, 64), (Replicate(), Shard(1)), mesh) is None
    assert partition_role(w, (2, 4, 64), (Shard(0), Shard(2)), mesh) is None
    assert partition_role(w, (2, 4, 63), (Replicate(), Shard(2)), mesh) is None
    assert partition_role("['blocks']['g0']['core']['w_out']", (2, 64, 32),
                          (Replicate(), Shard(1)), mesh) == "row"
    assert partition_role("['blocks']['g0']['core']['w_rec_gate']", (2, 64, 64),
                          (Replicate(), Shard(2)), mesh) == "column"
    # an xLSTM block's core is no RG-LRU: its conv has no role of a family
    families, _ = partitioned_leaves(get_config("xlstm-125m").reduced(), _mesh(2), [
        ("['blocks']['g0']['core']['conv']['w']", (2, 4, 64), (Replicate(), Shard(2)))])
    assert not families


# -- the model group's differentiable gather -----------------------------------

class _FakeGroup:
    """A model group of ``size`` ranks in one process: ``gather`` returns
    the blocks of every rank (given), ``scatter_sum`` this rank's block of
    the sum of every rank's gradient (given); counted like the real one."""

    def __init__(self, blocks, grads, index):
        from collections import Counter

        self.blocks, self.grads, self.index = blocks, grads, index
        self.size = len(blocks)
        self.kinds = Counter()

    def gather(self, x, dim):
        self.kinds["all_gather"] += 1
        parts = list(self.blocks)
        parts[self.index] = x
        return torch.cat(parts, dim=dim)

    def scatter_sum(self, g, dim):
        self.kinds["reduce_scatter"] += 1
        total = sum(self.grads[r] if r != self.index else g for r in range(self.size))
        return total.chunk(self.size, dim=dim)[self.index]


@pytest.mark.parametrize("dim", [-1, 1])
def test_the_differentiable_gather_transposes_to_a_reduce_scatter(dim):
    """``ModelParallel.gather_blocks``'s backward against autograd of the
    same function computed whole: three ranks each read the whole of a
    tensor whose blocks they hold, each through its own weights; the
    gradient of rank r's block of the sum of their losses is the sum over
    the ranks of their gradients' block r."""
    from repro_torch.training.data_parallel import ModelParallel

    gen = torch.Generator().manual_seed(5)
    m = 3
    whole = torch.randn(2, 6, 9, generator=gen)
    weights = [torch.randn(9 if dim == -1 else 6, 4, generator=gen) for _ in range(m)]

    def loss_of(r, x):
        y = x if dim == -1 else x.transpose(1, 2)
        return torch.tanh(y @ weights[r]).square().sum()

    w = whole.clone().requires_grad_()
    total = sum(loss_of(r, w) for r in range(m))
    want = torch.autograd.grad(total, w)[0].chunk(m, dim=dim)
    # every rank's gradient of the gathered whole, from its own loss
    grads = []
    for r in range(m):
        x = whole.clone().requires_grad_()
        grads.append(torch.autograd.grad(loss_of(r, x), x)[0])
    blocks = whole.chunk(m, dim=dim)
    for r in range(m):
        group = _FakeGroup(blocks, grads, r)
        mp = ModelParallel.__new__(ModelParallel)
        mp.gather, mp.scatter_sum = group.gather, group.scatter_sum
        mine = blocks[r].clone().requires_grad_()
        got = mp.gather_blocks(mine, dim)
        assert torch.equal(got, whole)
        (g,) = torch.autograd.grad(loss_of(r, got), mine)
        torch.testing.assert_close(g, want[r], rtol=1e-5, atol=1e-5)
        assert dict(group.kinds) == {"all_gather": 1, "reduce_scatter": 1}
