"""hubert-xlarge's encoder and llava's image request partitioned over
``model``: attention on its heads, the MLP on its columns and rows, the
vocabulary split. The port on 2 gloo ranks against the reference's placed
``jax.jit`` programs on 2 forced host devices, on the CPU.

``tests/torch_train_ranks.py ... frontend`` runs each side once as a
script (``FRONT_CASES``), both reduced and on (data=1, model=2), placed by
``ranks.vocab_names``:

* hubert-xlarge (2 layers, H=4, KV=4, head_dim 16): audio frames through
  the frontend (its projection, the masked frames' embedding and the conv
  positional embedding, replicated) into the non-causal encoder, whose K3
  calls each rank makes on its H/2 heads; ``lm_head`` (504) split on its
  504/2 columns;
* llava-next-mistral-7b (2 layers, H=4, KV=4): 8 image embeddings through
  the replicated projector, before the text tokens, into the partitioned
  GQA stack; ``embed`` and ``lm_head`` (512, untied) on their vocabulary.

Held, in f32, for each: two train steps (losses within 1e-5, every leaf
and moment within 1e-4), the first step's gradient within 1e-5 of
``jax.grad`` of the placed loss (a split leaf's block), the two ranks
identical, each K3 call on H/2 query and KV/2 key-value heads, no
parameter gathered, the collectives a step predicted and the split leaves
at half their bytes. Then hubert's forward (logits within 1e-4), and
llava's image request served greedily (prefill and 4 decode steps from
position 8 + 5): the reference's tokens, logits within 1e-4 and K/V held
on their heads, whose blocks side by side are the reference's caches
within 1e-4.
"""

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
WORLD = 2
CASES = dict(ranks.FRONT_CASES)
CFGS = {name: get_config(arch).reduced() for name, arch in ranks.FRONT_CASES}


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "frontend"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("frontend")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_frontend.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_frontend_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


def _split_dim(path, shape):
    spec = ranks.vocab_names(path, shape)
    return spec.index("model") if "model" in spec else None


def _block(path, w, rank):
    d = _split_dim(path, w.shape)
    if d is None:
        return w
    n = w.shape[d] // WORLD
    return np.take(w, range(rank * n, (rank + 1) * n), axis=d)


def test_the_configs():
    hubert, llava = CFGS["hubert"], CFGS["llava"]
    assert hubert.modality == "audio" and hubert.is_encoder and not hubert.tie_embeddings
    assert llava.modality == "vision_text" and llava.n_image_tokens == 8
    for cfg in (hubert, llava):
        assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads) == (2, 4, 4)
        assert cfg.vocab_size % WORLD == 0
    assert (hubert.vocab_size, llava.vocab_size) == (504, 512)


@pytest.mark.parametrize("name", CASES)
def test_steps_match_the_reference(results, name):
    ref, port = results
    want = ref[name]
    for got in (p[name] for p in port):
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_gradients_are_the_references(results, name):
    """The first step's gradient as each rank reduces it: a split leaf's
    block of ``jax.grad``'s, every replicated leaf (hubert's frontend,
    llava's projector, the norms) whole; no leaf summed over "model"."""
    ref, port = results
    want = ref[name]["grad"]
    for rank, got in enumerate(p[name] for p in port):
        assert set(got["grad"]) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got["grad"][path], _block(path, w, rank), atol=1e-5,
                                       err_msg=path)
        assert got["partial"] == []


@pytest.mark.parametrize("name", CASES)
def test_ranks_agree(results, name):
    _, port = results
    a, b = (p[name] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_computes_its_heads(results, name):
    """Every K3 call, in the steps (the forward and, under autograd, its
    backward's K3-bwd with it) and in serving (hubert's forward, llava's
    prefill of its image and text), gets H/2 query and KV/2 key-value
    heads; no parameter is gathered whole."""
    _, port = results
    cfg = CFGS[name]
    heads = [(cfg.n_heads // WORLD, cfg.n_kv_heads // WORLD)]
    for got in (p[name] for p in port):
        assert got["k3_heads"] == heads and got["serve"]["k3_heads"] == heads
        assert got["gathered"] == []


@pytest.mark.parametrize("name", CASES)
def test_step_collectives(results, name):
    """All-reduces: one a gradient leaf, the loss's 3, the global norm's
    one, the vocabulary's (the head's input gradient and the
    cross-entropy's maximum and sum; llava's lookup too: hubert reads
    frames), and per layer the model group's 2 after attention's and the
    MLP's row products and 2 before their column products backward;
    nothing else."""
    ref, port = results
    cfg = CFGS[name]
    n_leaves = sum(1 for p in ref[name]["state"] if p.startswith("['params']"))
    vocab = 3 if cfg.modality == "audio" else 4
    want = n_leaves + 3 + 1 + vocab + 4 * cfg.n_layers
    for got in (p[name] for p in port):
        for c in got["calls"]:
            assert c == {"collectives": want, "collectives.all_reduce": want,
                         "collectives.reduce_scatter": 0, "collectives.all_gather": 0}


@pytest.mark.parametrize("name", CASES)
def test_split_leaves_take_half_the_bytes(results, name):
    """Each split leaf's gradient, parameter and moments: half the whole's
    bytes on every rank, every other leaf whole; per layer attention's wq,
    wk, wv and wo and the MLP's three, and the vocabulary's leaves."""
    ref, port = results
    state = ref[name]["state"]
    cfg = CFGS[name]
    n_vocab = 1 if cfg.modality == "audio" else 2
    for got in (p[name] for p in port):
        split = 0
        for path, g in got["grad"].items():
            full = state["['params']" + path]
            half = _split_dim(path, full.shape) is not None
            assert g.nbytes * (2 if half else 1) == full.nbytes, path
            split += half
        assert split == 7 + n_vocab           # 2 layers stacked in one group
        for path, n in got["bytes"].items():
            half = _split_dim(path, state[path].shape) is not None
            assert n * (2 if half else 1) == state[path].nbytes, path


def test_hubert_forward_matches_the_reference(results):
    """hubert's forward over its frames on the placed parameters: the
    whole logits within 1e-4 of the reference's placed program; per layer
    2 all-reduces, and one all-gather of the logits' vocabulary blocks."""
    ref, port = results
    want = ref["hubert"]["serve"]
    cfg = CFGS["hubert"]
    for got in (p["hubert"]["serve"] for p in port):
        (logits,) = got["logits"]
        assert logits.shape == want["logits"][0].shape == (2, ranks.MP_PROMPT, cfg.vocab_size)
        np.testing.assert_allclose(logits, want["logits"][0], atol=1e-4)
        assert got["families"] == ["attn", "mlp", "vocab"]
        assert got["kinds"] == {"all_reduce": 2 * cfg.n_layers, "all_gather": 1}


def test_llava_image_request_matches_the_reference(results):
    """llava's image request: the prefill of 8 image tokens and 5 text
    tokens and 4 greedy decode steps from position 13 on the placed
    parameters: logits within 1e-4, the reference's greedy tokens; per
    pass 2 all-reduces a layer and one for the lookup, and one all-gather
    of the logits; K and V held on their heads (half the bytes a rank),
    the ranks' blocks side by side the reference's caches within 1e-4."""
    ref, port = results
    want = ref["llava"]["serve"]
    cfg = CFGS["llava"]
    passes = 1 + ranks.MP_DECODE
    assert ranks.first_position(cfg, want["inputs"]) == cfg.n_image_tokens + ranks.MP_PROMPT
    for got in (p["llava"]["serve"] for p in port):
        for a, b in zip(got["logits"], want["logits"], strict=True):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(got["greedy"], want["greedy"])
        assert got["families"] == ["attn", "mlp", "vocab"]
        assert got["kinds"] == {"all_reduce": passes * (2 * cfg.n_layers + 1),
                                "all_gather": passes}
    blocks = [p["llava"]["serve"]["blocks"] for p in port]
    assert set(blocks[0]) == set(want["caches"]) == {"['blocks']['g0']['k']",
                                                     "['blocks']['g0']['v']"}
    for path, w in want["caches"].items():
        np.testing.assert_allclose(np.concatenate([b[path] for b in blocks], axis=-2), w,
                                   atol=1e-4, err_msg=path)
        for p in port:
            _, local, whole, placements = p["llava"]["serve"]["cache"][path]
            assert 2 * local == whole and f"Shard(dim={w.ndim - 2})" in placements, path


def test_a_transposed_gradient_is_summed_in_its_own_layout(monkeypatch):
    """hubert's ``conv_pos`` weight (K, d) enters its depthwise conv as its
    transpose, so autograd hands its gradient back transposed. The data
    group's sum gives the all-reduce a contiguous view of that gradient's
    memory (NCCL refuses any other tensor: the card's first placed hubert
    step raised "Tensors must be contiguous") and returns it summed in its
    own layout; a gradient whose elements are not dense is summed as a
    contiguous copy."""
    import torch

    from repro_torch.models import make_model
    from repro_torch.training import data_parallel

    cfg = CFGS["hubert"]
    model = make_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in ranks.case_batches(cfg)[0].items()}
    w = params["conv_pos"]["w"].requires_grad_()
    (g,) = torch.autograd.grad(model.loss(params, batch)[0], w)
    assert not g.is_contiguous()

    def all_reduce(t, group=None):      # two ranks with one gradient
        assert t.is_contiguous()
        t.mul_(2)

    monkeypatch.setattr(data_parallel.dist, "all_reduce", all_reduce)
    dp = data_parallel.DataParallel.__new__(data_parallel.DataParallel)
    dp.group = None
    dp.reset()
    x = g.clone()
    assert dp.sum_(x) is x and x.stride() == g.stride() and torch.equal(x, 2 * g)
    x = g.clone()[:, ::2]
    got = dp.sum_(x)
    assert got.is_contiguous() and torch.equal(got, 2 * g[:, ::2])
    assert dp.calls == 2
