"""The KV cache held split over the ``model`` ranks for flash-decoding: the
port on 2 gloo ranks against the reference on 2 forced host devices, mesh
(data=1, model=2), on the CPU; and the prefill's blocks against the cache
held whole, in one process.

``tests/torch_launch_ranks.py ... split`` runs each side as a script: the
reduced qwen3 (G=2), deepseek-v2 (MLA's latent cache) and recurrentgemma
(the local ring buffer) each prefill 5 tokens into 16 slots, then take 5
decode steps, so that the position crosses the rank boundary at slot 8.
The reference places its attention caches ``P(None, "model", None,
None)`` and decodes with its flash-decode override; the port's prefill
writes the caches split (the ``"cache_split"`` rule,
``launch.flash_decode.SplitCaches``). Held, in f32:

* every step's logits within 1e-4 of the reference's;
* each rank's attention caches hold exactly 8 of the 16 slots (its
  prefill's, its decode's and ``init_cache``'s), recurrent states whole;
* the rows each rank wrote equal, bit for bit, the slots at its offset of
  the cache held whole and decoded through the same override (the
  whole-cache path, unchanged), and within 1e-5 those of one device's
  decode;
* caches made whole and placed by ``reshard_state(caches,
  SplitCaches(mesh).shardings(...))`` decode to the same logits, bit for
  bit;
* a split cache without the override raises: no rank decodes a part;
* recurrentgemma's recurrent states placed split over "model" too decode
  as the reference's jit does on that placement (each gathered whole for
  a step, the rank keeping its block).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_launch_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.models.attention import CacheBlock
from repro_torch.training.tree import leaves
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).with_name("torch_launch_ranks.py")
WORLD = 2
MODELS = list(ranks.MODELS)
HALF = ranks.CACHE // WORLD


def _run(mode: str, out: Path) -> None:
    res = subprocess.run([sys.executable, str(HELPER), mode, str(out), "split"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, f"{mode}: {res.stderr[-4000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("kv_split")
    _run("reference", out)
    _run("port", out)
    with open(out / "reference_split.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(WORLD):
        with open(out / f"port_split_{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


def _slot_dim(path: str):
    """The slot dim of an attention cache leaf, None for a recurrent state."""
    if not path.endswith(tuple(f"[{n!r}]" for n in ranks.SLOT_LEAVES)):
        return None
    return 2 if path.startswith("['blocks']") else 1


@pytest.mark.parametrize("name", MODELS)
def test_split_decode_matches_the_reference(results, name):
    ref, port = results
    want = ref[name]["logits"]
    for got in port:
        assert got[name]["logits"].shape == want.shape
        np.testing.assert_allclose(got[name]["logits"], want, atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_each_rank_holds_half_the_slots(results, name):
    _, port = results
    for got in port:
        got = got[name]
        n_split = 0
        for what in ("prefill_local", "local", "init_shapes"):
            for path, x in got[what].items():
                shape = x if what == "init_shapes" else x.shape
                whole = got["whole"][path].shape
                d = _slot_dim(path)
                if d is None:
                    assert tuple(shape) == whole, (what, path)
                    continue
                assert shape[d] == HALF and whole[d] == ranks.CACHE, (what, path)
                assert tuple(shape[:d]) + tuple(shape[d + 1:]) == whole[:d] + whole[d + 1:]
                n_split += 1
        assert n_split > 0
        for path, pl in got["placements"].items():
            assert ("Shard(dim=" in pl) == (_slot_dim(path) is not None), path


@pytest.mark.parametrize("name", MODELS)
def test_written_rows_equal_the_whole_cache_slots(results, name):
    """Rank r's block after the steps is slots [8r, 8r + 8) of the cache
    held whole: the prompt's rows on rank 0, the decode's rows past the
    boundary on rank 1, zeros beyond the last position."""
    _, port = results
    last = ranks.PROMPT + ranks.SPLIT_STEPS          # slots written: [0, last)
    for r, got in enumerate(port):
        got = got[name]
        for path, x in got["local"].items():
            d = _slot_dim(path)
            if d is None:
                np.testing.assert_array_equal(x, got["whole"][path], err_msg=path)
                continue
            own = [slice(None)] * x.ndim
            own[d] = slice(r * HALF, (r + 1) * HALF)
            np.testing.assert_array_equal(x, got["whole"][path][tuple(own)], err_msg=path)
            np.testing.assert_allclose(x, got["plain"][path][tuple(own)], atol=1e-5, err_msg=path)
            written = np.moveaxis(x, d, 0).reshape(HALF, -1)
            slots = np.arange(r * HALF, (r + 1) * HALF)
            assert np.all(np.abs(written[slots >= last]).max(initial=0) == 0), path
            assert np.all(np.abs(written[slots < last]).max(axis=1) > 0), path


@pytest.mark.parametrize("name", MODELS)
def test_placed_and_whole_caches_decode_alike(results, name):
    """Caches placed by ``reshard_state``, and caches held whole on every
    rank with the override, give the split prefill's logits bit for bit;
    one device's decode within 1e-5."""
    _, port = results
    for got in port:
        got = got[name]
        np.testing.assert_array_equal(got["reshard_logits"], got["logits"])
        np.testing.assert_array_equal(got["whole_logits"], got["logits"])
        np.testing.assert_allclose(got["plain_logits"], got["logits"], atol=1e-5)


def test_recurrent_state_split_decodes_as_the_reference(results):
    """recurrentgemma's RG-LRU states (h and the conv inputs) placed split
    on their last dim over "model", its attention caches on their slots:
    the 5 steps' logits within 1e-4 of the reference's jit on the same
    placement; each rank holds half of each state, and after the steps its
    block of what each step wrote, bit for bit the slice of the whole
    caches' decode."""
    ref, port = results
    name = ranks.REC_MODEL
    want = ref[name]["rec_logits"]
    for r, got in enumerate(port):
        got = got[name]
        np.testing.assert_allclose(got["rec_logits"], want, atol=1e-4)
        n_rec = 0
        for path, x in got["rec_local"].items():
            if not path.endswith(tuple(f"[{n!r}]" for n in ranks.REC_LEAVES)):
                continue
            assert "Shard(dim=" in got["rec_placements"][path], path
            whole = got["whole"][path]
            half = whole.shape[-1] // WORLD
            assert x.shape == whole.shape[:-1] + (half,), path
            np.testing.assert_array_equal(x, whole[..., r * half:(r + 1) * half], err_msg=path)
            n_rec += 1
        assert n_rec > 0


@pytest.mark.parametrize("name", MODELS)
def test_split_cache_without_the_override_raises(results, name):
    _, port = results
    for got in port:
        msg = got[name]["no_override"]
        assert msg is not None and "flash-decode override" in msg


# -- one process: the prefill's blocks against the cache held whole ----------

BLOCK_CASES = [  # (arch, prompt tokens, cache_len, blocks)
    ("qwen3-1.7b", 5, 16, 2), ("qwen3-1.7b", 20, 16, 4),           # padded; trimmed
    ("deepseek-v2-236b", 5, 16, 2), ("deepseek-v2-236b", 20, 16, 2),
    ("recurrentgemma-2b", 5, 16, 2),                                # ring buffer not yet full
    ("recurrentgemma-2b", 37, 16, 2), ("recurrentgemma-2b", 40, 64, 4),   # rolled
]


@pytest.mark.parametrize("arch,T,cache_len,n", BLOCK_CASES)
def test_prefill_blocks_equal_the_whole_cache(arch, T, cache_len, n):
    """Each layer's prefill into a block (rows [1, 2) of 2, slots in n
    blocks) writes exactly those rows and slots of the cache prefilled
    whole (a window's ring buffer rolled), bit for bit."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **ranks.MODELS.get(arch, {}))
    model = make_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    x = model._embed(params, {"tokens": torch.randint(0, cfg.vocab_size, (2, T),
                                                      generator=torch.Generator().manual_seed(1))})
    n_attn = 0
    with torch.no_grad():
        for kind, p in model._layers(params):
            _, whole = model._block_prefill(x, p, kind, cache_len)
            if kind not in ("attn", "local"):
                continue
            S = leaves(whole)[0].shape[1]
            for i in range(n):
                blk = CacheBlock(row=1, rows=1, slot=i * S // n, slots=S // n, total=S)
                _, part = model._block_prefill(x, p, kind, cache_len, blk)
                for key, w in whole.items():
                    assert torch.equal(part[key], w[1:2, blk.slot:blk.slot + blk.slots]), key
            n_attn += 1
    assert n_attn > 0
