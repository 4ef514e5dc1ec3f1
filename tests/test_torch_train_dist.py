"""Training state on a mesh: the port on 2 gloo ranks against the
reference on 2 forced host devices, on the CPU, mesh (data=2, model=1).

``tests/torch_train_ranks.py`` runs each side as a script: first the
reference (JAX), which writes its parameters, the shards of its placed
states and its ``jax.jit(make_train_step)`` results with the state
replicated and the batch on P("data"); then the port's 2 ranks (one torch
thread each, a ``file://`` store in the test's directory), each with its
own contiguous rows of the global batch. Held, in f32:

* every rank's local shard of ``reshard_state`` (one spec for every leaf;
  a tree of specs, "data" where the first dim splits) equals the
  reference's shard on the matching device, bit for bit;
* two data-parallel steps of the reduced qwen3 (microbatches 1, and 2
  with int8 compression) and the reduced granite-moe-1b under
  ``moe_chunks`` = 2, with masks that give the ranks other token counts:
  the losses within 1e-5, every parameter and moment within 1e-4 (the
  port's two-step tolerance, ``tests/test_torch_training.py``, at its
  schedule). A compression residual is the gradient's int8 rounding
  error: where the two programs' gradients straddle a rounding boundary
  the residual moves by one quantization step (the port's own
  single-device and mesh steps do so too), so a residual element may
  differ by more than 1e-4 at no more than 1 in 1000 elements of a leaf,
  and there by at most one step (twice the leaf's largest residual);
* the two ranks' states are bit-identical to each other;
* a checkpoint written by one process restores onto the mesh (a spec a
  leaf) and one saved from the mesh restores in one process, bit for bit;
* the collectives of a step: one all-reduce a gradient leaf, and the
  loss's sums.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_train_ranks.py")
WORLD = 2
CASES = [c[0] for c in ranks.CASES]


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_dist")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port, out


@pytest.mark.parametrize("kind", ["replicated", "per_leaf"])
def test_placed_shards_equal_the_reference_shards(results, kind):
    ref, port, _ = results
    want = ref["placed"][kind]
    for r, got in enumerate(port):
        assert set(got["placed"][kind]) == set(want)
        for path, shards in want.items():
            np.testing.assert_array_equal(got["placed"][kind][path], shards[r], err_msg=path)
    if kind == "per_leaf":     # the tree split some leaves and replicated others
        assert any(s[0].shape != s[1].shape or not np.array_equal(s[0], s[1])
                   for s in want.values())
        assert any(np.array_equal(s[0], s[1]) for s in want.values())


@pytest.mark.parametrize("case", CASES)
def test_data_parallel_steps_match_the_reference(results, case):
    ref, port, _ = results
    want = ref["cases"][case]
    for got in port:
        got = got["cases"][case]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            g = got["state"][path]
            if not path.startswith("['compress']"):
                np.testing.assert_allclose(g, w, atol=1e-4, err_msg=path)
                continue
            off = np.abs(g - w) > 1e-4
            assert off.sum() <= w.size // 1000, path
            assert np.all(np.abs(g - w)[off] <= 2 * np.abs(w).max() + 1e-4), path


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_bit_identical_states(results, case):
    _, port, _ = results
    a, b = (p["cases"][case] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


def test_step_collectives(results):
    """One all-reduce a gradient leaf, the cross-entropy's numerator (and
    its transpose) and count a microbatch, the MoE aux loss's two sums a
    layer (again in the backward), and with microbatches one all-gather a
    batch entry."""
    ref, port, _ = results
    n_leaves = sum(1 for path in ref["cases"]["qwen3"]["state"] if path.startswith("['params']"))
    for got in port:
        assert got["cases"]["qwen3"]["calls"] == [n_leaves + 3] * ranks.STEPS
        assert got["cases"]["qwen3_mb2_compress"]["calls"] == [n_leaves + 2 * 3 + 3] * ranks.STEPS
        assert got["cases"]["granite_moe_chunks2"]["calls"][0] > got["cases"]["qwen3"]["calls"][0]


def test_world1_checkpoint_restores_onto_the_mesh(results):
    """Saved by one process, restored on the 2 ranks with a spec a leaf:
    each rank's local shard is its part of the saved tensor."""
    from repro_torch.training.tree import flatten_with_paths

    ref, port, _ = results
    saved = dict(flatten_with_paths(ranks.world1_state(ref)))
    split = ranks.spec_tree_names([(p, x.numpy()) for p, x in saved.items()
                                   if p.startswith("['params']")])
    for r, got in enumerate(port):
        assert set(got["restored"]) == set(saved)
        for path, x in saved.items():
            want = x.numpy()
            if split.get(path):
                want = np.split(want, WORLD)[r]
            np.testing.assert_array_equal(got["restored"][path], want, err_msg=path)


def test_mesh_checkpoint_restores_in_one_process(results):
    """Saved from the mesh (rank 0 writes), restored without one: every
    leaf as the ranks held it after two steps, bit for bit."""
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.tree import flatten_with_paths

    ref, port, out = results
    name, arch, mb, comp, _ = ranks.CASES[0]
    target = ranks._setup(ref["cases"][name], arch, mb, comp)[3]
    back, extras = Checkpointer(out / "ckpt2").restore(None, target, device="cpu")
    assert extras["step"] == ranks.STEPS
    want = port[0]["cases"][name]["state"]
    got = dict(flatten_with_paths(back))
    assert set(got) == set(want)
    for path, x in got.items():
        assert x.dtype == torch.from_numpy(want[path]).dtype, path
        np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)
