"""A mesh with both axes larger than one: the port on 4 gloo ranks on
(data=2, model=2) against the reference's placed ``jax.jit`` programs on 4
forced host devices, on the CPU.

``tests/torch_train_ranks.py ... mesh22`` runs each side once as a script
(``ranks.MESH22_CASES``). Each data row of ranks steps its own rows of the
batch (the reference's batch on P("data")), and each model column
partitions the compute as on (data=1, model=2):

* the reduced qwen3 with G = 2 and its tied embedding, placed by
  ``ranks.vocab_names`` (Megatron's placement with the vocabulary split);
* the reduced granite-moe-1b with its experts on their expert dim under
  ``moe_chunks`` = 2 (one chunk a data rank; the routing replicated over
  each model row).

Held, in f32: two train steps (losses within 1e-5, every leaf and moment
within 1e-4 of the reference's), the first step's reduced gradient of
every leaf (each rank's block of a split one) within 1e-5 of ``jax.grad``
of the placed loss, all 4 ranks' states equal; the collectives by kind as
the 2-rank cases count them, every gradient's reduction one all-reduce on
the rank's data group (the partitioned leaves' too: their blocks are never
summed over "model"), the rest on the model group; greedy serving (prefill
and 4 decode steps) on K/V split on their heads, then qwen3's on K/V
placed on their slots over "model" with their rows over "data", and with
its parameters replicated through the flash-decoding override, whose
gather of each step's rows runs on the data group: logits within 1e-4,
the reference's greedy tokens.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_train_ranks as ranks
from repro_torch.configs import get_config
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_train_ranks.py")
WORLD = 4
CASES = [c[0] for c in ranks.MESH22_CASES]
ARCH = {name: (arch, changes, role, vocab) for name, arch, changes, role, vocab, _ in
        ranks.MESH22_CASES}


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "mesh22"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh22")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_mesh22.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_mesh22_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


def _cfg(name):
    arch, changes, _, _ = ARCH[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _split_dim(name, path, shape):
    _, _, role, vocab = ARCH[name]
    spec = ranks.case_names(path, shape, role, vocab)
    return spec.index("model") if "model" in spec else None


def _model_rank(port, rank):
    """A rank's index on the model axis: its place in its model group."""
    return port[rank]["model_group"].index(rank)


def test_the_groups_are_the_meshs_rows_and_columns(results):
    _, port = results
    for rank, got in enumerate(port):
        assert got["model_group"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert got["data_group"] == [rank % 2, rank % 2 + 2]


@pytest.mark.parametrize("name", CASES)
def test_steps_match_the_reference(results, name):
    ref, port = results
    want = ref[name]
    for got in port:
        got = got[name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_all_four_ranks_agree(results, name):
    _, port = results
    first = port[0][name]
    for got in port[1:]:
        got = got[name]
        assert got["losses"] == first["losses"] and got["calls"] == first["calls"]
        for path, x in first["state"].items():
            np.testing.assert_array_equal(x, got["state"][path], err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_reduced_gradients_are_the_references(results, name):
    """The first step's gradient once the data group has averaged it: a
    split leaf's the rank's block (by its model index) of ``jax.grad``'s
    over the global batch, every replicated leaf whole, each within 1e-5."""
    ref, port = results
    want = ref[name]["grad"]
    for rank, got in enumerate(port):
        got = got[name]["reduced"]
        mi = _model_rank(port, rank)
        assert set(got) == set(want)
        for path, w in want.items():
            d = _split_dim(name, path, w.shape)
            if d is not None:
                n = w.shape[d] // 2
                w = np.take(w, range(mi * n, (mi + 1) * n), axis=d)
            np.testing.assert_allclose(got[path], w, atol=1e-5, err_msg=path)


def _model_group_all_reduces(cfg, vocab: bool) -> int:
    """The model group's all-reduces a step (one microbatch): the global
    norm's one, per layer attention's 2 (after wo; before its column
    products in the backward) and the MLP's 2 or the MoE's 3 (after the
    combine; its tokens and its combine weights in the backward), GQA's q
    and k norms' packed sum, and the vocabulary's 4 where it is split."""
    per_layer = 2 + (3 if cfg.moe else 2)
    return 1 + per_layer * cfg.n_layers + int(cfg.qk_norm) + (4 if vocab else 0)


@pytest.mark.parametrize("name", CASES)
def test_collectives_as_on_two_ranks(results, name):
    """The collectives a step by kind are the (data=1, model=2) cases'
    (``test_torch_vocab_parallel``'s and ``test_torch_model_parallel``'s
    counts: all-reduces only); by group, the data group's are one a
    gradient leaf, the loss's 3 and, for the MoE, the aux loss's 3 a
    layer; the model group's the partitioned compute's."""
    ref, port = results
    cfg = _cfg(name)
    vocab = ARCH[name][3]
    n_leaves = sum(1 for p in ref[name]["state"] if p.startswith("['params']"))
    data = n_leaves + 3 + (3 * cfg.n_layers if cfg.moe else 0)
    model = _model_group_all_reduces(cfg, vocab)
    for got in port:
        dg, mg = tuple(got["data_group"]), tuple(got["model_group"])
        for calls, groups in zip(got[name]["calls"], got[name]["groups"], strict=True):
            assert calls == {"collectives": data + model, "collectives.all_reduce": data + model,
                             "collectives.reduce_scatter": 0, "collectives.all_gather": 0}
            assert groups == {("all_reduce", dg): data, ("all_reduce", mg): model}


@pytest.mark.parametrize("name", CASES)
def test_gradients_reduce_over_the_data_group_only(results, name):
    """Each leaf's gradient, a partitioned leaf's block above all, is
    averaged by exactly one all-reduce, on the rank's data group; no
    parameter is gathered for the compute."""
    ref, port = results
    n_leaves = sum(1 for p in ref[name]["state"] if p.startswith("['params']"))
    parted = sum(1 for p, w in ref[name]["grad"].items()
                 if _split_dim(name, p, w.shape) is not None)
    assert parted
    for got in port:
        reduce_groups = got[name]["reduce_groups"]
        assert len(reduce_groups) == n_leaves
        assert all(g == [("all_reduce", tuple(got["data_group"]))] for g in reduce_groups)
        assert got[name]["gathered"] == []


@pytest.mark.parametrize("name", CASES)
def test_head_split_serving_matches_the_reference(results, name):
    """Prefill and 4 greedy decode steps, K and V split on their heads over
    "model" (every row on every rank): logits within 1e-4, the same greedy
    tokens; the model group's collectives as on two ranks."""
    ref, port = results
    cfg = _cfg(name)
    vocab = ARCH[name][3]
    want = ref[name]["serve"]
    passes = 1 + ranks.MP_DECODE
    kinds = {"all_reduce": passes * (2 * cfg.n_layers + int(vocab))}
    if vocab:
        kinds["all_gather"] = passes
    for got in port:
        sv = got[name]["serve"]
        assert len(sv["logits"]) == passes
        for a, b in zip(sv["logits"], want["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["kinds"] == kinds
        for path, (shape, local, whole, placements) in sv["cache"].items():
            assert 2 * local == whole and "Shard(dim=3)" in placements, path


def test_slot_split_serving_with_rows_over_data(results):
    """qwen3's K and V placed on their slots over "model" and their rows
    over "data" (``SplitCaches._sharding`` on this mesh), read by its
    partitioned layers: the reference's logits within 1e-4 and its greedy
    tokens, the logits of the head-split caches bit for bit, the caches
    after the steps within 1e-4 of the reference's, the placement kept."""
    ref, port = results
    want = ref["qwen3_vocab"]["serve"]
    for got in port:
        sv = got["slots"]
        for step, logits in enumerate(sv["logits"]):
            np.testing.assert_allclose(logits, want["logits"][step + 1], atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["same_logits"]
        assert set(sv["moved"]) == set(want["caches"])
        for path, x in sv["moved"].items():
            np.testing.assert_allclose(x, want["caches"][path], atol=1e-4, err_msg=path)
        assert len(sv["placements"]) == ranks.MP_DECODE
        assert all(all(kept.values()) for kept in sv["placements"])


def test_flash_decoding_gathers_over_the_data_group(results):
    """qwen3's parameters replicated, its caches written split by the
    prefill (K and V on their slots over "model", their rows over "data")
    and decoded through the flash-decoding override: each rank computes
    its rows' attention over its slots, and each decode step gathers the
    rows of every attention layer over the rank's data group. The
    reference's logits within 1e-4 and its greedy tokens."""
    ref, port = results
    cfg = _cfg("qwen3_vocab")
    want = ref["qwen3_vocab"]["serve"]
    for got in port:
        sv = got["flash"]
        for a, b in zip(sv["logits"], want["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["gathers"] == [tuple(got["data_group"])] * (ranks.MP_DECODE * cfg.n_layers)
        for path, (shape, placements) in sv["cache"].items():
            assert placements == "(Shard(dim=1), Shard(dim=2))", path
            assert shape[1] == 1 and shape[2] == ranks.MP_CACHE // 2, path
