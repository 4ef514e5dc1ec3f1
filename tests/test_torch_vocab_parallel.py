"""The embedding and the head partitioned over ``model`` on their
vocabulary: the port on 2 gloo ranks against the reference's placed
``jax.jit`` programs on 2 forced host devices, on the CPU.

``tests/torch_train_ranks.py ... vocab`` runs each side once as a script.
Two cases on (data=1, model=2) (``ranks.VOCAB_CASES``), each placed as
Megatron places it (``ranks.megatron_names``) with the vocabulary split
too (``ranks.vocab_names``: ``embed`` (V, d) on its rows, ``lm_head`` (d,
V) on its columns, their moments alike): the reduced qwen3 with G = 2 and
its tied embedding, and the reduced deepseek-v2 (MLA on its heads, its
experts on their expert dim) with its untied embedding and head. The
reference's GSPMD computes a masked lookup summed over "model" and the
cross-entropy reduced over "model". Held, in f32:

* two train steps: losses within 1e-5 and every leaf and moment within
  1e-4 of the reference's placed program; the first step's gradient of
  every leaf (each rank's block of a split one) within 1e-5 of ``jax.grad``
  of the placed loss; the two ranks identical;
* the collectives a step exactly: the Megatron-placed step's, plus 4
  all-reduces a microbatch for the vocabulary (the lookup's sum, the
  loss's row max and its packed sums, the head's input gradient) and no
  gather;
* ``embed``, ``lm_head``, their gradients and moments at half their bytes
  on a rank; every loss call gets the rank's (B, T, V/2) logits from the
  vocabulary-parallel cross-entropy, never the whole (B, T, V);
* greedy serving (a 5-token prompt's prefill and 4 decode steps): the
  reference's tokens, logits within 1e-4, and per pass one all-reduce a
  block after each row product, one for the lookup and one all-gather of
  the logits.

The rule that names the "vocab" family (``launch.mesh.partitioned_leaves``)
is held here in one process too, where it partitions and where the leaves
stay gathered; and the vocabulary-parallel lookup and cross-entropy at
one rank against the plain ones, bit for bit.
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
from repro_torch.models import layers
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_train_ranks.py")
WORLD = 2
CASES = [c[0] for c in ranks.VOCAB_CASES]
ARCH = {name: (arch, changes, role) for name, arch, changes, role in ranks.VOCAB_CASES}
VOCAB = ("['embed']", "['lm_head']")


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "vocab"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_vocab.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_vocab_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


def _cfg(name):
    arch, changes, _ = ARCH[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _split_dim(name, path, shape):
    """The dim of a parameter split over "model" in case ``name``, or None."""
    spec = ranks.vocab_names(path, shape, ARCH[name][2])
    return spec.index("model") if "model" in spec else None


def _block(name, path, w, rank):
    d = _split_dim(name, path, w.shape)
    if d is None:
        return w
    n = w.shape[d] // WORLD
    return np.take(w, range(rank * n, (rank + 1) * n), axis=d)


@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_steps_match_the_reference(results, name):
    ref, port = results
    want = ref[name]
    for got in port:
        got = got[name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5)
        assert set(got["state"]) == set(want["state"])
        for path, w in want["state"].items():
            np.testing.assert_allclose(got["state"][path], w, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_gradients_are_the_references(results, name):
    """The first step's gradient as each rank reduces it: a split leaf's
    (the embedding's rows, the head's columns) the rank's block of
    ``jax.grad``'s, every replicated leaf whole, each within 1e-5."""
    ref, port = results
    want = ref[name]["grad"]
    for rank, got in enumerate(port):
        got = got[name]["grad"]
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], _block(name, path, w, rank), atol=1e-5,
                                       err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_ranks_agree(results, name):
    _, port = results
    a, b = (p[name] for p in port)
    assert a["losses"] == b["losses"] and a["calls"] == b["calls"]
    for path, x in a["state"].items():
        np.testing.assert_array_equal(x, b["state"][path], err_msg=path)


def _model_group_per_layer(cfg) -> int:
    """The model group's all-reduces a layer of a Megatron-placed step:
    attention's after wo and in the backward (GQA 1, MLA 3), the MLP's or
    the MoE's after its row product or combine and in the backward (MLP
    1, MoE 2); and the MoE aux loss's 3 over the data group."""
    attn = 2 if cfg.attention != "mla" else 4
    ffn = 2 if not cfg.moe else 3 + 3
    return attn + ffn


@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_step_collectives(results, name):
    """No gather, no reduce-scatter; all-reduces: one a gradient leaf, the
    loss's 3 (the data group's sums), the global norm's one over "model",
    the layers' (``_model_group_per_layer``), GQA's q and k norms' packed
    sum, and the vocabulary's 4: the lookup's sum, the loss's row max and
    its packed sums, the head's input gradient."""
    ref, port = results
    cfg = _cfg(name)
    n_leaves = sum(1 for p in ref[name]["state"] if p.startswith("['params']"))
    norms = int(cfg.qk_norm and cfg.attention != "mla")
    want = n_leaves + 3 + 1 + _model_group_per_layer(cfg) * cfg.n_layers + norms + 4
    for got in port:
        for c in got[name]["calls"]:
            assert c == {"collectives": want, "collectives.all_reduce": want,
                         "collectives.reduce_scatter": 0, "collectives.all_gather": 0}


@pytest.mark.parametrize("name", CASES)
def test_vocab_leaves_take_half_the_bytes(results, name):
    """``embed`` and ``lm_head`` (where the model has it), their
    gradients and moments: half the whole's bytes on every rank."""
    ref, port = results
    state = ref[name]["state"]
    want = 1 if _cfg(name).tie_embeddings else 2
    for got in port:
        got = got[name]
        grads = [p for p in got["grad"] if p.endswith(VOCAB)]
        assert len(grads) == want
        for path in grads:
            assert 2 * got["grad"][path].nbytes == state["['params']" + path].nbytes, path
        held = [p for p in got["bytes"] if p.endswith(VOCAB)]
        assert len(held) == 3 * want            # the parameter, mu and nu
        for path in held:
            assert 2 * got["bytes"][path] == state[path].nbytes, path


@pytest.mark.parametrize("name", CASES)
def test_no_rank_builds_the_whole_logits(results, name):
    """Every loss call of the steps gets this rank's (B, T, V/2) block of
    the logits, through the vocabulary-parallel cross-entropy."""
    _, port = results
    V = _cfg(name).vocab_size
    for got in port:
        assert got[name]["ce"] == [("vocab_parallel_cross_entropy",
                                    (ranks.B, ranks.T, V // WORLD))]


@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_serving_matches_the_reference(results, name):
    """Prefill and 4 greedy decode steps with the parameters so placed:
    logits within 1e-4 of the reference's, the same greedy tokens; per
    pass one all-reduce after each block's attention and MLP or MoE, one
    for the lookup, and one all-gather of the last position's logits."""
    ref, port = results
    cfg = _cfg(name)
    want = ref[name]["serve"]
    fams = ["mla", "moe"] if cfg.attention == "mla" else ["attn", "mlp"]
    passes = 1 + ranks.MP_DECODE
    for got in port:
        sv = got[name]["serve"]
        assert len(sv["logits"]) == passes
        for a, b in zip(sv["logits"], want["logits"], strict=True):
            assert a.shape[-1] == cfg.vocab_size
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(sv["greedy"], want["greedy"])
        assert sv["families"] == fams + ["vocab"]
        assert sv["kinds"] == {"all_reduce": passes * (2 * cfg.n_layers + 1),
                               "all_gather": passes}


# -- the rule that names the family, in one process ---------------------------

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


def _vocab(path, shape):
    return ranks.vocab_names(path, shape)


def _vocab_experts(path, shape):
    return ranks.vocab_names(path, shape, "expert")


def _embed_on_d(path, shape):
    """The tied embedding split on d (its last dim): not the vocabulary."""
    if path.endswith("['embed']"):
        return (None, "model")
    return _vocab(path, shape)


def _embed_only(path, shape):
    """The embedding on its rows, the untied head replicated."""
    return () if path.endswith("['lm_head']") else _vocab_experts(path, shape)


def _head_only(path, shape):
    """The untied head on its columns, the embedding replicated."""
    return () if path.endswith("['embed']") else _vocab_experts(path, shape)


VOCAB_CLASSIFY = {  # name: (arch, config changes, model ranks, spec rule, families)
    "qwen3_tied": ("qwen3-1.7b", ranks.MP_CFG, 2, _vocab, {"attn", "mlp", "vocab"}),
    "deepseek_untied": ("deepseek-v2-236b", {}, 2, _vocab_experts, {"mla", "moe", "vocab"}),
    # an audio model has a head (vocabulary 504) and no embedding
    "hubert_head_only": ("hubert-xlarge", {}, 2, _vocab, {"attn", "mlp", "vocab"}),
    "embed_on_d": ("qwen3-1.7b", ranks.MP_CFG, 2, _embed_on_d, {"attn", "mlp"}),
    "embed_split_head_not": ("deepseek-v2-236b", {}, 2, _embed_only, {"mla", "moe"}),
    "head_split_embed_not": ("deepseek-v2-236b", {}, 2, _head_only, {"mla", "moe"}),
    # 510 rows do not split over 4 ranks (nor do qwen3's 2 KV heads)
    "vocab_does_not_divide": ("qwen3-1.7b", {**ranks.MP_CFG, "vocab_size": 510}, 4, _vocab,
                              {"mlp"}),
}


@pytest.mark.parametrize("name", VOCAB_CLASSIFY)
def test_which_placements_partition_the_vocabulary(name):
    """"vocab" is partitioned where every vocabulary leaf the model has is
    split evenly on its vocabulary (the embedding's rows, the head's
    columns); an embedding split on d, one of the two split and the other
    replicated, and a vocabulary the axis does not divide stay gathered.
    The split vocabulary leaves are among the paths exactly where the
    family is."""
    arch, changes, m, rule, want = VOCAB_CLASSIFY[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    families, paths = partitioned_leaves(cfg, _mesh(m), _items(cfg, rule))
    assert set(families) == want
    vocab = {p for p in paths if p.endswith(VOCAB)}
    if "vocab" in want:
        n = (0 if cfg.modality == "audio" else 1) + (0 if cfg.tie_embeddings else 1)
        assert len(vocab) == n
    else:
        assert not vocab


def test_the_vocab_role_and_its_prefixes():
    """A vocabulary leaf's role from its placement, with or without a
    state's prefix; the embedding split on d, the head on d, a leaf split
    over "data" too, or a vocabulary that does not divide: no role."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(2, 2)
    rows, cols = (Replicate(), Shard(0)), (Replicate(), Shard(1))
    for prefix in ("", "['params']", "['opt']['mu']", "['opt']['nu']", "['compress']"):
        assert partition_role(prefix + "['embed']", (512, 64), rows, mesh) == "vocab"
        assert partition_role(prefix + "['lm_head']", (64, 512), cols, mesh) == "vocab"
        assert partition_role(prefix + "['embed']", (512, 64), cols, mesh) is None
        assert partition_role(prefix + "['lm_head']", (64, 512), rows, mesh) is None
    assert partition_role("['embed']", (512, 64), (Shard(1), Shard(0)), mesh) is None
    assert partition_role("['embed']", (511, 64), rows, mesh) is None
    # a leaf of that name inside a block is no vocabulary
    assert partition_role("['blocks']['g0']['embed']", (512, 64), rows, mesh) is None


def test_the_expert_parallel_override_keeps_the_vocabulary_split():
    """Under the launcher's ``moe_apply`` override (``gathered=("moe",)``)
    the MoE stays gathered and the vocabulary stays partitioned."""
    cfg = get_config("deepseek-v2-236b").reduced()
    families, paths = partitioned_leaves(cfg, _mesh(2), _items(cfg, _vocab_experts),
                                         gathered=("moe",))
    assert set(families) == {"mla", "vocab"}
    assert {p for p in paths if p.endswith(VOCAB)} == {"['embed']", "['lm_head']"}


# -- the lookup and the cross-entropy at one rank, bit for bit ----------------

class _OneRank:
    """A model group of one rank: every reduction is the identity."""

    index, size = 0, 1
    families = frozenset({"vocab"})

    def sum_(self, x):
        return x

    max_ = sum_

    def enter(self, x):
        return x

    def leave(self, x):
        return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z_loss,masked", [(0.0, False), (0.0, True), (1e-3, True)])
def test_one_rank_cross_entropy_is_the_plain_one(dtype, z_loss, masked):
    """At one rank the vocabulary-parallel cross-entropy is
    ``softmax_cross_entropy``, in the loss and in the logits' gradient, bit
    for bit (ATen's order of operations), with a mask and ``z_loss``."""
    gen = torch.Generator().manual_seed(3)
    logits = (4 * torch.randn(3, 7, 96, generator=gen)).to(dtype)
    labels = torch.randint(0, 96, (3, 7), generator=gen)
    mask = torch.rand(3, 7, generator=gen) < 0.6 if masked else None
    out = []
    for fn in (lambda x: layers.softmax_cross_entropy(x, labels, mask, z_loss),
               lambda x: layers.vocab_parallel_cross_entropy(x, labels, _OneRank(), mask,
                                                             z_loss)):
        x = logits.clone().requires_grad_()
        loss = fn(x)
        out.append((loss.detach(), torch.autograd.grad(loss, x)[0]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1)


def test_one_rank_lookup_is_the_plain_one():
    """At one rank the masked lookup is the plain row gather, rows and
    table gradient bit for bit."""
    gen = torch.Generator().manual_seed(4)
    table = torch.randn(40, 8, generator=gen)
    tokens = torch.randint(0, 40, (2, 9), generator=gen)
    out = []
    for parallel in (None, _OneRank()):
        t = table.clone().requires_grad_()
        rows = layers.embed_lookup(t, tokens, torch.bfloat16, parallel)
        out.append((rows.detach(), torch.autograd.grad(rows.float().square().sum(), t)[0]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
