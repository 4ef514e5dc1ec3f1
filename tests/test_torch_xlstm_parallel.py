"""xlstm-125m partitioned over ``model`` on its heads: the mLSTM and sLSTM
blocks each computed on H/m heads. The port on 2 gloo ranks against the
reference's placed ``jax.jit`` programs on 2 forced host devices, on the
CPU.

``tests/torch_train_ranks.py ... xlstm`` runs each side once as a script:
the reduced xlstm-125m cut to one tile of its pattern (6 layers: five
mLSTM blocks and an sLSTM, stacked over the tiles' dim; d=64, H=4, so the
mLSTM's heads are 32 wide and the sLSTM's 16; the vocabulary of 512 tied)
on (data=1, model=2), placed by
``ranks.xlstm_names``: the mLSTM's w_up, w_gate_up, wq, wk, wv, w_igate and
w_fgate on their columns, w_down on its rows, its conv and out_norm on
their channels; the sLSTM's r_i, r_f, r_z and r_o on H, its out_norm on its
channels and w_ff_up on its rows, w_in and w_ff_down replicated; the tied
embedding on its vocabulary. The reference's GSPMD partitions the same
products. One tile, not the reduced config's two: the xLSTM at init
grows its gradients layer by layer (the largest reaches 6.1 over two
tiles, 2.3 over one) and f32 rounding with them. On this batch, scaled to
each leaf's largest magnitude, each f32 gradient (the port's, the
reference's) lies 6e-5 to 9e-5 from the port run in float64 over two
tiles and 9e-6 over one, and the reference's own ``jax.jit`` and op-by-op
gradients part by 4.4e-5 and 9e-6 (``scripts/xlstm_grad_rounding.py``):
1e-5 is the rounding floor of one tile, and below what two tiles can
hold. Held, in f32:

* two train steps: losses within 1e-5 and every leaf and moment within
  1e-4, but at an element whose first-step gradient in the reference is
  below 1e-6: Adam's first step there is the sign of a gradient that f32
  rounding can swing, so it is held within Adam's two whole steps (one
  element of wq, 1.8e-4 apart); the first step's gradient of every leaf
  (each rank's block of a split one, the sLSTM's w_in whole: summed over
  "model") within 2e-5 (twice that floor) of ``jax.grad`` of the placed
  loss, scaled to the leaf's largest magnitude (1 or more) as
  ``test_torch_flash_grad.py`` scales it; the two ranks identical;
* each rank's mLSTM and sLSTM run H/2 heads and their norms its channels,
  in the steps and in serving; no parameter is gathered; w_in is the leaf
  the step sums over "model";
* the collectives a step, predicted: per block the model group's 2
  all-reduces forward (out_norm's mean of squares, the row product's sum)
  and 2 backward (out_norm's, the input's), per mLSTM layer one all-gather
  of (xu, conv output) and one reduce-scatter of its gradient;
* the split leaves, their gradients and moments, and the states at half
  their bytes a rank;
* greedy serving (prefill and 4 decode steps): the reference's tokens,
  logits within 1e-4; the states held on their heads (the mLSTM's conv
  inputs on their channels), whose blocks gathered are the reference's
  caches within 1e-4.

The rule that names the families (``launch.mesh.partitioned_leaves``) is
held here in one process too: a placement that splits w_in or w_ff_up on
its columns leaves the sLSTM gathered.
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
CFG = dataclasses.replace(get_config(ranks.XL_ARCH).reduced(), **ranks.XL_CFG)
N_MLSTM = CFG.block_pattern.count("mlstm") * (CFG.n_layers // len(CFG.block_pattern))
# twice f32's rounding floor of this model's scaled gradients (the module's
# docstring)
GRAD_ATOL = 2e-5
# Adam's whole step each way over the two steps: the most an element whose
# first update is the sign of a rounding-sized gradient can move
ADAM_SWING = 2 * ranks.STEPS * ranks.LR["lr"]
# the leaves each group of the tree splits: an mLSTM core's 11, an sLSTM
# core's 6 (its four recurrent weights, out_norm and w_ff_up)
MLSTM_SPLIT, SLSTM_SPLIT = 11, 6


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "xlstm"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("xlstm")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_xlstm.pkl", "rb") as f:
        ref = pickle.load(f)["xlstm"]
    port = []
    for r in range(WORLD):
        with open(out / f"port_xlstm_{r}.pkl", "rb") as f:
            port.append(pickle.load(f)["xlstm"])
    return ref, port


def _split_dim(path, shape):
    spec = ranks.xlstm_names(path, shape)
    return spec.index("model") if "model" in spec else None


def _block(path, w, rank):
    d = _split_dim(path, w.shape)
    if d is None:
        return w
    n = w.shape[d] // WORLD
    return np.take(w, range(rank * n, (rank + 1) * n), axis=d)


def _param_path(path):
    """The parameter's path of a state leaf's (after the state's keys)."""
    for prefix in ("['params']", "['opt']['mu']", "['opt']['nu']"):
        if path.startswith(prefix):
            return path[len(prefix):]
    raise KeyError(path)


def test_the_config_is_one_tile_of_the_reduced_xlstm():
    assert (CFG.n_layers, CFG.d_model, CFG.n_heads, CFG.vocab_size) == (6, 64, 4, 512)
    assert CFG.tie_embeddings and N_MLSTM == 5 and CFG.n_heads % WORLD == 0
    assert CFG.block_pattern == get_config(ranks.XL_ARCH).reduced().block_pattern
    assert 2 * CFG.d_model // CFG.n_heads == 32 and CFG.d_model // CFG.n_heads == 16


def test_steps_match_the_reference(results):
    ref, port = results
    for got in port:
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5)
        assert set(got["state"]) == set(ref["state"])
        for path, w in ref["state"].items():
            g = got["state"][path]
            off = np.abs(g - w) > 1e-4
            if not off.any():
                continue
            # only where the reference's first gradient is below 1e-6, and
            # there within Adam's two whole steps
            first = ref["grad"][_param_path(path)]
            assert np.all(np.abs(first[off]) < 1e-6), path
            assert np.all(np.abs(g - w)[off] <= ADAM_SWING), path
            assert off.sum() <= 2, path


def test_gradients_are_the_references(results):
    """The first step's gradient as each rank reduces it: a split leaf's
    block of ``jax.grad``'s, every replicated leaf whole; the sLSTM's w_in
    (each rank reads its heads' columns) summed over "model"."""
    ref, port = results
    want = ref["grad"]
    for rank, got in enumerate(port):
        assert set(got["grad"]) == set(want)
        for path, w in want.items():
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got["grad"][path] / scale, _block(path, w, rank) / scale,
                                       atol=GRAD_ATOL, err_msg=path)
        w_in = [p for p in got["grad"] if p.endswith(ranks.SLSTM_W_IN)]
        assert w_in and got["partial"] == w_in


def test_ranks_agree(results):
    _, port = results
    a, b = port
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


def test_each_rank_computes_its_heads(results):
    """Every mLSTM sequence form and every sLSTM cell step runs on H/2
    heads, and every out_norm on the rank's channels (the mLSTM's 2d/2,
    the sLSTM's d/2), in the steps and in serving; no attention, no K3
    launch and no parameter gathered whole."""
    _, port = results
    half = CFG.n_heads // WORLD
    want = sorted({("mlstm", half), ("slstm", half), ("out_norm", CFG.d_model),
                   ("out_norm", CFG.d_model // WORLD)})
    for got in port:
        for part in (got, got["serve"]):
            assert part["xlstm"] == want
            assert part["k3_heads"] == [] and part["attn"] == []
        assert got["gathered"] == []


def test_step_collectives(results):
    """All-reduces: one a gradient leaf, the loss's 3, the global norm's
    one, the packed sum of w_in's gradient, the vocabulary's 4, and per
    block 2 forward (out_norm's mean of squares, the row product's sum) and
    2 backward (out_norm's gradient, the input's); per mLSTM layer one
    all-gather of (xu, conv output) and one reduce-scatter of their
    gradient."""
    ref, port = results
    n_leaves = sum(1 for p in ref["state"] if p.startswith("['params']"))
    want = n_leaves + 3 + 1 + 1 + 4 + 4 * CFG.n_layers
    for got in port:
        for c in got["calls"]:
            assert c == {"collectives": want + 2 * N_MLSTM, "collectives.all_reduce": want,
                         "collectives.reduce_scatter": N_MLSTM,
                         "collectives.all_gather": N_MLSTM}


def test_split_leaves_take_half_the_bytes(results):
    """Each split leaf's gradient, parameter and moments: half the whole's
    bytes on every rank, every other leaf whole; per mLSTM group its 11
    leaves split, per sLSTM group 6, and the tied embedding."""
    ref, port = results
    state = ref["state"]
    n_groups = len(CFG.block_pattern)
    for got in port:
        split = []
        for path, g in got["grad"].items():
            full = state["['params']" + path]
            half = _split_dim(path, full.shape) is not None
            assert g.nbytes * (2 if half else 1) == full.nbytes, path
            if half:
                split.append(path)
        assert len(split) == (n_groups - 1) * MLSTM_SPLIT + SLSTM_SPLIT + 1
        assert not any(p.endswith(ranks.XLSTM_REPLICATED) for p in split)
        for path, n in got["bytes"].items():
            half = _split_dim(path, state[path].shape) is not None
            assert n * (2 if half else 1) == state[path].nbytes, path


def test_serving_matches_the_reference(results):
    """Prefill and 4 greedy decode steps: logits within 1e-4, the same
    greedy tokens; per pass 2 all-reduces a block (out_norm's, the row
    product's) and one for the lookup, one all-gather an mLSTM layer and
    one of the logits."""
    ref, port = results
    want = ref["serve"]
    passes = 1 + ranks.MP_DECODE
    for got in port:
        sv = got["serve"]
        for a, b in zip(sv["logits"], want["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["families"] == ["mlstm", "slstm", "vocab"]
        assert sv["kinds"] == {"all_reduce": passes * (2 * CFG.n_layers + 1),
                               "all_gather": passes * (N_MLSTM + 1)}


def test_states_are_held_on_their_heads(results):
    """Each state leaf is split over "model": the mLSTM's C, n and m and the
    sLSTM's c, n, m and h on H, the mLSTM's conv inputs on their channels;
    half the bytes a rank, and the two ranks' blocks side by side are the
    reference's caches after the decode steps within 1e-4."""
    ref, port = results
    want = ref["serve"]["caches"]
    blocks = [got["serve"]["blocks"] for got in port]
    assert set(blocks[0]) == set(want)
    for path, w in want.items():
        spec = ranks._xlstm_cache_spec(path, w)
        d = spec.index("model")
        assert d == (w.ndim - 1 if path.endswith("['conv']") else 2), path
        got = np.concatenate([b[path] for b in blocks], axis=d)
        for r in range(WORLD):
            _, local, whole, placements = port[r]["serve"]["cache"][path]
            assert 2 * local == whole and f"Shard(dim={d})" in placements, path
        np.testing.assert_allclose(got, w, atol=1e-4, err_msg=path)
    assert len(want) == 4 * len(CFG.block_pattern)


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


def _on_columns(leaf):
    """``ranks.xlstm_names`` with ``leaf`` of the core split on its last
    dim instead."""
    def rule(path, shape):
        if path.endswith(f"['core']['{leaf}']"):
            return (None,) * (len(shape) - 1) + ("model",)
        return ranks.xlstm_names(path, shape)
    return rule


def _replicated(leaf):
    def rule(path, shape):
        return () if path.endswith(leaf) else ranks.xlstm_names(path, shape)
    return rule


def _r_on_dh(path, shape):
    """The sLSTM's recurrent weights split on their last dim (dh), not H."""
    if path.endswith(ranks.XLSTM_HEAD):
        return (None,) * (len(shape) - 1) + ("model",)
    return ranks.xlstm_names(path, shape)


CLASSIFY = {  # name: (model ranks, spec rule, families)
    "xlstm_names": (2, ranks.xlstm_names, {"mlstm", "slstm", "vocab"}),
    # w_in's columns are gate-major: a contiguous block is no rank's heads
    "w_in_on_its_columns": (2, _on_columns("w_in"), {"mlstm", "vocab"}),
    # w_ff_up's columns are the GLU's two halves
    "w_ff_up_on_its_columns": (2, _on_columns("w_ff_up"), {"mlstm", "vocab"}),
    "r_on_dh": (2, _r_on_dh, {"mlstm", "vocab"}),
    # the mLSTM's norm replicated: its channels are no rank's alone
    "mlstm_norm_replicated": (2, _replicated("['core']['out_norm']['scale']"), {"vocab"}),
    # H = 4 does not split over 8 ranks; the vocabulary of 512 does
    "heads_do_not_divide": (8, ranks.xlstm_names, {"vocab"}),
}


@pytest.mark.parametrize("name", CLASSIFY)
def test_which_placements_partition_the_xlstm(name):
    """"mlstm" and "slstm" are partitioned where every group of the family
    is whole in its roles and ``model`` divides the heads; w_in or w_ff_up
    on its columns, the recurrent weights on dh, or an out_norm replicated
    leave that family gathered. The split leaves are the families'
    exactly."""
    m, rule, want = CLASSIFY[name]
    families, paths = partitioned_leaves(CFG, _mesh(m), _items(CFG, rule))
    assert set(families) == want
    core = {p for p in paths if "['core']" in p}
    n = {"mlstm": (len(CFG.block_pattern) - 1) * MLSTM_SPLIT, "slstm": SLSTM_SPLIT}
    assert len(core) == sum(n[f] for f in ("mlstm", "slstm") if f in want)
    assert not any(p.endswith(ranks.XLSTM_REPLICATED) for p in paths)


def test_the_head_and_norm_roles():
    """An sLSTM recurrent weight (H, dh, dh) split on H is in the "head"
    role, with or without a state's prefix, in a tile or the tail; on
    another dim, with a data dim split too, or where H does not divide:
    none. An xLSTM out_norm's scale split on its channels is "width"."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(2, 2)
    for prefix in ("", "['params']", "['opt']['nu']"):
        assert partition_role(prefix + "['blocks']['g5']['core']['r_i']", (2, 4, 16, 16),
                              (Replicate(), Shard(1)), mesh) == "head"
        assert partition_role(prefix + "['tail'][0]['core']['r_o']", (4, 16, 16),
                              (Replicate(), Shard(0)), mesh) == "head"
    r = "['blocks']['g5']['core']['r_f']"
    assert partition_role(r, (2, 4, 16, 16), (Replicate(), Shard(2)), mesh) is None
    assert partition_role(r, (2, 4, 16, 16), (Shard(0), Shard(1)), mesh) is None
    assert partition_role(r, (2, 3, 16, 16), (Replicate(), Shard(1)), mesh) is None
    assert partition_role("['blocks']['g0']['core']['out_norm']['scale']", (2, 128),
                          (Replicate(), Shard(1)), mesh) == "width"
    assert partition_role("['blocks']['g5']['core']['w_ff_up']", (2, 64, 192),
                          (Replicate(), Shard(1)), mesh) == "row"
    assert partition_role("['blocks']['g5']['core']['w_in']", (2, 64, 256),
                          (Replicate(), Shard(2)), mesh) is None


def test_one_rank_norm_is_the_plain_norm():
    """The partitioned out_norm at one rank (the ranks' means of squares
    summed and divided by m = 1) is the plain ``rmsnorm`` bit for bit, and
    so is its gradient."""
    from repro_torch.models import xlstm
    from repro_torch.models.layers import rmsnorm

    class One:
        size = 1

        def all_sum(self, x):
            return x.clone()

    gen = torch.Generator().manual_seed(3)
    h = torch.randn(2, 5, 48, generator=gen)
    p = {"scale": torch.randn(48, generator=gen)}
    cfg = dataclasses.replace(CFG, norm_eps=1e-6)
    outs = []
    for norm in (lambda x: rmsnorm(x, p, cfg.norm_eps), lambda x: xlstm._out_norm(x, p, cfg,
                                                                                   One())):
        x = h.clone().requires_grad_()
        y = norm(x)
        (g,) = torch.autograd.grad((y * y.detach().flip(-1)).sum(), x)
        outs.append((y, g))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
