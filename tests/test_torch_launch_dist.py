"""The port's two multi-device programs on 2 gloo ranks against the
reference's ``shard_map`` programs on 2 forced host devices, on the CPU.

``tests/torch_launch_ranks.py`` runs each side as a script: first the
reference (JAX, ``--xla_force_host_platform_device_count=2``), which
writes the inputs (numpy, from seeds), its parameters and its results;
then the port's 2 ranks (``torch.multiprocessing`` spawn, a ``file://``
store in the test's directory, one torch thread each), on the meshes
(data, model) = (1, 2) and (2, 1) (and, for decode attention, (pod,
data, model) = (1, 2, 1): two data axes taken together). Every case is
batched into those two runs. Held, in f32:

* ``make_decode_attention``: GQA and MLA's latent MQA with ragged valid
  lengths (one of them <= S/2, so that a model rank has no valid slot),
  1e-5; the shapes it declines, as the reference declines them;
* ``decode_step`` of the reduced qwen3 (G=2), deepseek-v2 (MLA) and
  recurrentgemma (local ring buffer) with the override installed, after a
  prefill of 5 tokens into 16 slots: logits 1e-4;
* ``make_moe_apply_ep`` on the reduced granite-moe-1b and deepseek-v2
  (shared experts): out and aux 1e-5, and the gradients of sum(out^2) +
  aux with respect to x and the router and expert weights 2e-4 against
  ``jax.grad`` (on (2, 1) the port splits f over the data axis, which the
  reference does only for large experts: the same function);
* with a capacity large enough that nothing drops, the EP output equals
  the single-device ``moe_apply(no_drop=True)``.

Every rank's results are held, not only rank 0's.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_launch_ranks as ranks
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_launch_ranks.py")
WORLD = 2


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out)], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_dist")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


@pytest.mark.parametrize("shape", ranks.MESHES + (ranks.POD_MESH,), ids=str)
@pytest.mark.parametrize("case", list(ranks.ATTN_CASES))
def test_decode_attention_matches_reference(results, shape, case):
    ref, port = results
    want = ref["attn"][shape, case]
    for got in port:
        assert got["attn"][shape, case].shape == want.shape
        np.testing.assert_allclose(got["attn"][shape, case], want, atol=1e-5)


@pytest.mark.parametrize("shape", ranks.MESHES, ids=str)
@pytest.mark.parametrize("case", list(ranks.DECLINE))
def test_decode_attention_declines_where_reference_does(results, shape, case):
    ref, port = results
    for got in port:
        assert got["decline"][shape, case] == ref["decline"][shape, case]


def test_decline_cases_cover_each_condition(results):
    ref, _ = results
    assert ref["decline"][(1, 2), "two_tokens"] and ref["decline"][(1, 2), "odd_slots"]
    assert ref["decline"][(2, 1), "odd_batch"] and not ref["decline"][(1, 2), "odd_batch"]


@pytest.mark.parametrize("name", list(ranks.MODELS))
def test_decode_step_with_override_matches_reference(results, name):
    ref, port = results
    want = ref["models"][name]["logits"]
    for got in port:
        assert got["models"][name].shape == want.shape
        np.testing.assert_allclose(got["models"][name], want, atol=1e-4)


@pytest.mark.parametrize("shape", ranks.MESHES, ids=str)
@pytest.mark.parametrize("name", ranks.MOE_MODELS)
def test_moe_ep_matches_reference_and_its_gradients(results, shape, name):
    ref, port = results
    want = ref["moe"][shape, name]
    for got in port:
        g = got["moe"][shape, name]
        assert g["split"] == (shape == (2, 1))
        np.testing.assert_allclose(g["out"], want["out"], atol=1e-5)
        assert g["aux"] == pytest.approx(want["aux"], abs=1e-5)
        np.testing.assert_allclose(g["grad_x"], want["grad_x"], atol=2e-4)
        assert set(g["grad_w"]) == set(want["grad_w"])
        for w in want["grad_w"]:
            np.testing.assert_allclose(g["grad_w"][w], want["grad_w"][w], atol=2e-4, err_msg=w)


@pytest.mark.parametrize("shape", ranks.MESHES, ids=str)
@pytest.mark.parametrize("name", ranks.MOE_MODELS)
def test_moe_ep_without_drops_is_drop_free_moe(results, shape, name):
    _, port = results
    for got in port:
        assert got["no_drop"][shape, name] <= 1e-5
