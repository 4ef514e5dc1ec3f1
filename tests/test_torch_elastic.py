"""``training.elastic.reshard_state`` and ``Checkpointer.restore(shardings=)``
on the CPU: the port of ``tests/test_distributed.py``'s
``test_elastic_reshard_roundtrip`` (one device per leaf), a single spec
for every leaf, a tree of specs that does not match the state; then, on a
one-rank gloo group and a (data=1) mesh in a process of its own, mesh
placements: the state placed replicated and split, specs that do not fit
a leaf raising with its path, a checkpoint restored onto the mesh (one
spec, a tree of specs, the target's own placements) bit for bit, and the
step refusing a state it cannot step (a plain tensor in a meshed state)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.training.elastic import reshard_state, specs_for
from repro_torch.training.tree import leaves
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _state():
    return {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones((4,))}


def test_elastic_reshard_roundtrip():
    state = _state()
    sh = {k: torch.device("cpu") for k in state}
    out = reshard_state(state, sh)
    torch.testing.assert_close(out["w"], state["w"], rtol=0, atol=0)


def test_a_single_spec_places_every_leaf():
    state = {"params": _state(), "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    out = reshard_state(state, "cpu")
    assert [t.device.type for t in leaves(out)] == ["cpu"] * 3
    for a, b in zip(leaves(state), leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_a_spec_at_a_subtree_places_all_of_it():
    state = {"params": _state(), "opt": {"mu": _state(), "step": torch.tensor(1)}}
    # leaves in jax.tree_util's order: "opt" before "params"
    assert specs_for(state, {"params": "cpu", "opt": None}) == [None] * 3 + ["cpu", "cpu"]


@pytest.mark.parametrize("bad", [{"w": "cpu"}, {"w": "cpu", "b": "cpu", "c": "cpu"},
                                 ["cpu", "cpu"], {"w": {"x": "cpu"}, "b": "cpu"}],
                         ids=["missing", "extra", "list", "deeper"])
def test_a_tree_that_does_not_match_raises(bad):
    with pytest.raises(ValueError, match="do not match"):
        reshard_state(_state(), bad)


_MESH = """
import json, os, sys, tempfile
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch.mesh import Sharding, make_mesh
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.elastic import reshard_state
from repro_torch.training.tree import flatten_with_paths, leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.training import TrainConfig, make_train_step
from repro_torch.training.train_step import init_train_state

d = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0)
mesh = make_mesh((1,), ("data",), device="cpu")
gen = torch.Generator().manual_seed(0)
state = {"params": {"w": torch.randn((4, 6), generator=gen),
                    "v": torch.randn((3, 5), generator=gen).bfloat16()},
         "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
out = {}

def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None

rep = reshard_state(tree_map(torch.clone, state), Sharding(mesh))
out["replicated"] = all(t.placements[0].is_replicate() and torch.equal(t.to_local(), s)
                        for t, s in zip(leaves(rep), leaves(state)))
split = reshard_state(tree_map(torch.clone, state),
                      {"params": {"w": Sharding(mesh, ("data", None)), "v": Sharding(mesh)},
                       "opt": Sharding(mesh)})
out["split"] = [t.placements[0].is_shard() for t in leaves(split)]
out["gathered"] = all(torch.equal(a, b) for a, b in zip(leaves(reshard_state(split, "cpu")),
                                                        leaves(state)))
out["no_axis"] = raises(lambda: reshard_state(
    state["params"], {"w": Sharding(mesh, ("model", None)), "v": "cpu"}))
out["rank"] = raises(lambda: reshard_state(state, {"params": Sharding(mesh, ("data",)),
                                                   "opt": Sharding(mesh)}))
out["twice"] = raises(lambda: reshard_state(state["params"], {"w": Sharding(mesh, ("data", "data")),
                                                              "v": "cpu"}))

ck = Checkpointer(os.path.join(d, "ck"))
ck.save(7, state, {"step": 7})
same = lambda a, b: all(x.dtype == y.dtype and torch.equal(getattr(x, "to_local", lambda: x)(), y)
                        for x, y in zip(leaves(a), leaves(b)))
one, _ = ck.restore(None, state, shardings=Sharding(mesh))
out["restore_one"] = same(one, state) and all(t.placements[0].is_replicate() for t in leaves(one))
tree, _ = ck.restore(None, state, shardings={"params": {"w": Sharding(mesh, ("data", None)),
                                                        "v": "cpu"}, "opt": Sharding(mesh)})
out["restore_tree"] = same(tree, state) and [type(t).__name__ for t in leaves(tree)]
ck.save(8, split, {"step": 8})                 # a mesh state: rank 0 writes, then a barrier
own, extras = ck.restore(None, split)          # onto the target's own placements
out["restore_own"] = (same(own, state) and extras["step"] == 8
                      and [t.placements[0].is_shard() for t in leaves(own)] == out["split"])
out["restore_bad"] = raises(lambda: ck.restore(None, state, shardings={"params": Sharding(mesh)}))

cfg = get_config("qwen3-1.7b").reduced()
model = make_model(cfg, compute_dtype=torch.float32)
st = init_train_state(model, torch.Generator().manual_seed(0), TrainConfig())
step = make_train_step(model, TrainConfig())
batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
         "labels": torch.zeros((2, 8), dtype=torch.int32),
         "mask": torch.ones((2, 8), dtype=torch.bool)}
mixed = reshard_state(tree_map(torch.clone, st), Sharding(mesh))
mixed["opt"]["step"] = torch.tensor(0, dtype=torch.int32)
out["step_mixed"] = raises(lambda: step(mixed, batch))
dist.destroy_process_group()
print(json.dumps(out), flush=True)
os._exit(0)     # no interpreter teardown after the gloo group (see test_torch_launch.py)
"""


@pytest.fixture(scope="module")
def on_mesh():
    res = subprocess.run([sys.executable, "-c", _MESH], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_placed_replicated_and_split_on_a_mesh(on_mesh):
    assert on_mesh["replicated"] and on_mesh["gathered"]
    assert on_mesh["split"] == [False, False, True]      # opt.step, params.v, params.w


# μ and ν placed apart, a mesh of "model" alone and a recurrent state split
# over "model" run: tests/test_torch_train_placed.py (the "apart" and
# "model_only" placements) and tests/test_torch_kv_split.py hold them to
# the reference at world 2. The ids are fixed so that they stay stable.
@pytest.mark.parametrize("case,words", [
    pytest.param("no_axis", ["['w']", "'model'"], id="no_axis-words0"),
    pytest.param("rank", ["['params']['v']", "1 entries"], id="rank-words1"),
    pytest.param("twice", ["['w']", "twice"], id="twice-words2"),
    pytest.param("restore_bad", ["do not match"], id="restore_bad-words3"),
    pytest.param("step_mixed", ["['opt']['step']", "plain tensor"], id="step_mixed-words5"),
])
def test_what_does_not_fit_raises_naming_the_leaf(on_mesh, case, words):
    msg = on_mesh[case]
    assert msg is not None, case
    for w in words:
        assert w in msg, (case, msg)


@pytest.mark.parametrize("case", ["restore_one", "restore_tree", "restore_own"])
def test_restore_onto_the_mesh_is_bit_identical(on_mesh, case):
    assert on_mesh[case]
    if case == "restore_tree":
        assert on_mesh[case] == ["DTensor", "Tensor", "DTensor"]
