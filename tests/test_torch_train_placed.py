"""The train step on a state placed leaf by leaf: the port on 2 gloo ranks
against the reference's ``jax.jit(make_train_step)`` on 2 forced host
devices, on the CPU.

``tests/torch_train_ranks.py ... placed`` runs each side as a script, for
four placements (``ranks.PLACEMENTS``): ZeRO-1 on the mesh (data=2,
model=1), the moments and the compression residuals split over "data" at
each leaf's first dim that divides, the parameters replicated; on
(data=1, model=2) the parameters, moments and residuals split over
"model" (granite's experts on their expert dim, every other leaf at its
last dim that divides); ZeRO-1 with ν replicated (μ and ν of a leaf
placed apart: the update runs on μ's placement, ν is redistributed in and
back); and the "model" placement on a mesh of "model" alone, (2,), whose
two ranks each step the whole batch (the reference's batch replicated).
Each runs two steps of the reduced qwen3 (microbatches 1, and 2 with int8
compression) and, on the first two, the reduced granite-moe-1b. Held, in
f32:

* before the steps, each rank's local shard of every leaf equals the
  reference's shard on the matching device, bit for bit;
* after two steps, the losses within 1e-5 and every parameter and moment
  within 1e-4 of the reference's placed program. One exception, pinned
  to the reference itself: the reference's placed program rounds
  differently from its own single-device step, and Adam turns a gradient
  element near zero into a step of up to lr whatever its size, so at an
  element where those two reference programs differ by more than 1e-4
  the port is held to the single-device one instead (at 1e-4; granite on
  "model" has one such element of 8192 in ``wo``, 3.3e-4 apart in the
  reference). Residuals follow ``tests/test_torch_train_dist.py``'s
  one-quantization-step rule;
* the two ranks' losses, collectives and gathered states are identical;
* ZeRO-1's moments and residuals take exactly half the bytes of the
  replicated state's on every rank, on every leaf that divides;
* the collectives a step: one reduce-scatter (never an all-reduce) and
  one all-gather of the updated parameter for each leaf split over
  "data"; one all-gather a parameter split over "model" and no
  reduce-scatter there; the global norm's, the compression scale's and
  its error's sums one all-reduce each;
* a ZeRO-1 checkpoint saved from the mesh restores in one process bit
  for bit, and a one-process checkpoint restores onto the ZeRO-1
  placements.
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
KINDS = list(ranks.PLACEMENTS)
CASES = [c[0] for c in ranks.CASES]
PAIRS = [(kind, c[0]) for kind in KINDS for c in ranks.cases_of(kind)]
MOMENTS = ("['opt']['mu']", "['opt']['nu']", "['compress']")


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "placed"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_placed")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_placed.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_placed_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port, out


def _names(kind, case, path, shape):
    experts = dict((c[0], c[1]) for c in ranks.CASES)[case].startswith("granite")
    return ranks.placed_names(kind, path, shape, experts)


@pytest.mark.parametrize("kind,case", PAIRS)
def test_placed_shards_equal_the_reference_shards(results, kind, case):
    ref, port, _ = results
    want = ref[kind, case]["before"]
    n_split = 0
    for r, got in enumerate(port):
        got = got[kind, case]["before"]
        assert set(got) == set(want)
        for path, shards in want.items():
            np.testing.assert_array_equal(got[path], shards[r], err_msg=path)
            n_split += shards[r].shape != ref[kind, case]["state"][path].shape
    assert n_split > 0          # the placement split leaves


@pytest.mark.parametrize("kind,case", PAIRS)
def test_placed_steps_match_the_reference(results, kind, case):
    ref, port, _ = results
    want = ref[kind, case]
    single = ref[want["single"]]
    for got in port:
        got = got[kind, case]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            g = got["state"][path]
            if path.startswith("['compress']"):
                off = np.abs(g - w) > 1e-4
                assert off.sum() <= w.size // 1000, path
                assert np.all(np.abs(g - w)[off] <= 2 * np.abs(w).max() + 1e-4), path
                continue
            off = np.abs(g - w) > 1e-4
            # only where the reference's placed program leaves its own
            # single-device step, and there within 1e-4 of that one
            assert np.all(np.abs(single[path] - w)[off] > 1e-4), path
            np.testing.assert_allclose(g[off], single[path][off], atol=1e-4, err_msg=path)


@pytest.mark.parametrize("kind,case", PAIRS)
def test_ranks_agree(results, kind, case):
    _, port, _ = results
    a, b = (p[kind, case] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


@pytest.mark.parametrize("case", CASES)
def test_zero1_halves_the_moment_bytes(results, case):
    """Every rank holds half of each moment and residual that divides, and
    whole parameters."""
    ref, port, _ = results
    full = {p: w.size * w.itemsize for p, w in ref["zero1", case]["state"].items()}
    halved = 0
    for got in port:
        got = got["zero1", case]
        for path, n in got["bytes"].items():
            shape = ref["zero1", case]["state"][path].shape
            split = bool(_names("zero1", case, path, shape))
            assert split == (path.startswith(MOMENTS) and any(s % 2 == 0 for s in shape)), path
            assert n * (2 if split else 1) == full[path], path
            halved += split
    assert halved > 0


def _split_leaves(ref, kind, case, prefix):
    return [p for p, w in ref[kind, case]["state"].items()
            if p.startswith(prefix) and _names(kind, case, p, w.shape)]


@pytest.mark.parametrize("kind,case", PAIRS)
def test_placed_step_collectives(results, kind, case):
    """ZeRO-1: a reduce-scatter and an all-gather for each parameter whose
    moments are split, the batch's all-gathers with microbatches; μ and ν
    placed apart: the same, and one more all-gather a leaf for ν's block
    back on its own (replicated) placement; on "model" (and on a mesh of
    "model" alone): an all-gather a split parameter for the forward, none
    back (the parameter is placed like its moments), no reduce-scatter
    (no Megatron group is whole: wo and w_down are split on their last
    dim, so every leaf takes the gathered route). The qwen3 cases'
    all-reduces exactly: each gradient leaf not split over "data", the
    loss's sums (3 a microbatch), and one a mesh dim for the global norm
    and, with compression, the scale's maximum and the error's sums."""
    ref, port, _ = results
    name, arch, mb, comp, _ = next(c for c in ranks.CASES if c[0] == case)
    n_leaves = sum(1 for p in ref[kind, case]["state"] if p.startswith("['params']"))
    mom = len(_split_leaves(ref, kind, case, "['opt']['mu']"))
    par = len(_split_leaves(ref, kind, case, "['params']"))
    batch_gathers = 3 if (mb > 1 and ranks.data_size(kind) > 1) else 0
    for got in port:
        for c in got[kind, case]["calls"]:
            if kind in ("zero1", "apart"):
                assert c["collectives.reduce_scatter"] == mom > 0
                assert c["collectives.all_gather"] == (2 if kind == "apart" else 1) * mom \
                    + batch_gathers
                reduced = n_leaves - mom
            else:
                assert c["collectives.reduce_scatter"] == 0
                assert c["collectives.all_gather"] == par > 0
                reduced = n_leaves
            if not arch.startswith("granite"):
                assert c["collectives.all_reduce"] == reduced + 3 * mb + 1 + (2 if comp else 0)
            assert c["collectives"] == sum(v for k, v in c.items() if k != "collectives")


def test_zero1_checkpoint_restores_in_one_process(results):
    """Saved from the ZeRO-1 mesh (rank 0 writes), restored without one:
    every leaf as the ranks held it after two steps, bit for bit."""
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.tree import flatten_with_paths

    ref, port, out = results
    name, arch, mb, comp, _ = ranks.CASES[0]
    target = ranks._setup(ref["zero1", name], arch, mb, comp)[3]
    back, extras = Checkpointer(out / "ckpt_zero1").restore(None, target, device="cpu")
    assert extras["step"] == ranks.STEPS
    want = port[0]["zero1", name]["state"]
    got = dict(flatten_with_paths(back))
    assert set(got) == set(want)
    for path, x in got.items():
        assert x.dtype == torch.from_numpy(want[path]).dtype, path
        np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)


def test_world1_checkpoint_restores_onto_zero1(results):
    """Saved by one process, restored on the 2 ranks onto the ZeRO-1
    placements: each rank's local shard is its part of the saved tensor."""
    from repro_torch.training.tree import flatten_with_paths

    ref, port, _ = results
    name = ranks.CASES[0][0]
    saved = dict(flatten_with_paths(ranks.world1_state({"cases": {name: ref["zero1", name]}})))
    for r, got in enumerate(port):
        assert set(got["restored"]) == set(saved)
        for path, x in saved.items():
            want = x.numpy()
            names = _names("zero1", name, path, want.shape)
            if names:
                want = np.split(want, WORLD, axis=names.index("data"))[r]
            np.testing.assert_array_equal(got["restored"][path], want, err_msg=path)
