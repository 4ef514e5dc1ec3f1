"""The port's ``launch/`` modules against the reference's, on the CPU:
the tuning knobs (and ``REPRO_KV_CHUNK`` read by ``chunked_attention``),
the serving CLI's printed stats, the mesh helpers (in a subprocess that
opens a one-rank gloo group: importing ``launch.mesh`` starts nothing),
and the meta-device input specs of every config x shape cell. The
two-rank programs are ``tests/test_torch_launch_dist.py``'s."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.launch import tuning as jtuning
from repro.models import make_model as jmake_model
from repro.models.attention import chunked_attention as jchunked_attention
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import mesh, serve, specs, tuning
from repro_torch.models import make_model
from repro_torch.models.attention import chunked_attention
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-5

# (knob, environment variable, a value to set, what the knob reads from it)
KNOBS = [
    ("kv_chunk", "REPRO_KV_CHUNK", "256", 256),
    ("remat_policy", "REPRO_REMAT_POLICY", "dots", "dots"),
    ("seq_parallel", "REPRO_SEQ_PARALLEL", "0", False),
    ("causal_fold", "REPRO_CAUSAL_FOLD", "1", True),
    ("pure_dp_threshold", "REPRO_PURE_DP_THRESHOLD", "0", 0),
    ("flash_decode", "REPRO_FLASH_DECODE", "0", False),
    ("microbatches", "REPRO_MICROBATCH", "4", 4),
    ("scan_unroll", "REPRO_SCAN_UNROLL", "1", True),
]


@pytest.mark.parametrize("name,var,value,want", KNOBS, ids=[k[0] for k in KNOBS])
def test_tuning_knob_matches_reference(monkeypatch, name, var, value, want):
    monkeypatch.delenv(var, raising=False)
    assert getattr(tuning, name)() == getattr(jtuning, name)()
    monkeypatch.setenv(var, value)
    assert getattr(tuning, name)() == getattr(jtuning, name)() == want


def _attention_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return f(2, 3, 4, 16), f(2, S, 2, 16), f(2, S, 2, 16), np.array([S - 100, S // 3], np.int32)


def _both(q, k, v, valid, **kw):
    """(port, reference) non-causal chunked_attention on the same inputs;
    ``valid`` None: the path of a whole sequence (no valid lengths, the
    memory-safe VJP)."""
    jkw = dict(kw, causal=False)
    tkw = dict(jkw)
    if valid is not None:
        jkw.update(kv_valid_len=jnp.asarray(valid), q_offset=jnp.asarray(0))
        tkw.update(kv_valid_len=torch.from_numpy(valid))
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    want = jchunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    return got, np.asarray(want)


@pytest.mark.parametrize("ragged", [True, False], ids=["decode-ragged", "sequence"])
def test_kv_chunk_knob_is_read_by_chunked_attention(monkeypatch, ragged):
    """REPRO_KV_CHUNK=256 moves both packages' chunk: the port's result
    is its own explicit 256-key chunking (which differs from the default
    1024 in its rounding, over S = 700 keys) and the reference's."""
    q, k, v, valid = _attention_inputs(700)
    valid = valid if ragged else None
    own = {c: _both(q, k, v, valid, kv_chunk=c)[0] for c in (256, 1024)}
    assert not torch.equal(own[256], own[1024])          # the case tells the chunks apart
    monkeypatch.setenv("REPRO_KV_CHUNK", "256")
    got, want = _both(q, k, v, valid)
    assert torch.equal(got, own[256])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("chunk", ["1", "4096"], ids=["one-key", "past-S"])
@pytest.mark.parametrize("ragged", [True, False], ids=["decode-ragged", "sequence"])
def test_kv_chunk_knob_extremes_match_reference(monkeypatch, chunk, ragged):
    """A chunk of one key, and one longer than S (the port clamps it to
    S; the reference pads nothing then)."""
    monkeypatch.setenv("REPRO_KV_CHUNK", chunk)
    q, k, v, valid = _attention_inputs(120, seed=1)
    got, want = _both(q, k, v, valid if ragged else None)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_serve_prints_the_reference_stats(capsys, seed):
    args = ["--arch", "qwen3-1.7b", "--seed", str(seed)]
    assert jserve.main(args) == 0
    want = capsys.readouterr().out
    assert serve.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("engine stats:\n") and "prefix_hit_token_ratio" in got
    assert got == want


_MESH_PROBE = """
import json, os, sys, tempfile
import torch
import repro_torch.launch.mesh as mesh
import torch.distributed as dist
lazy = [dist.is_initialized(), torch.cuda.is_initialized()]
import dataclasses
from repro_torch.configs import get_config
from repro_torch.launch.flash_decode import make_decode_attention
from repro_torch.launch.moe_ep import make_moe_apply_ep
from repro_torch.models import moe
from repro_torch.models.attention import chunked_attention
torch.set_num_threads(1)
store = os.path.join(sys.argv[1], "store")
dist.init_process_group("gloo", init_method="file://" + store, world_size=1, rank=0)
try:
    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    out = dict(lazy=lazy, data_axes=mesh.data_axes(m), model_axis=mesh.model_axis(m),
               sizes=[mesh.axis_size(m, n) for n in (None, "data", "model", ("data", "model"))],
               no_model=make_decode_attention(mesh.make_mesh((1,), ("data",), device="cpu")))
    # at world 1: flash-decode is chunked_attention (to the last bit, also
    # over several chunks), EP is moe_apply
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((3, 1, 4, 16), (3, 40, 2, 16), (3, 40, 2, 16)))
    valid = torch.tensor([1, 17, 40])
    os.environ["REPRO_KV_CHUNK"] = "16"
    got = make_decode_attention(m)(q, k, v, valid, 0.25)
    want = chunked_attention(q, k, v, causal=False, kv_valid_len=valid, scale=0.25)
    out["decode_err"] = float((got - want).abs().max())
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), capacity_factor=1.0)
    p = moe.moe_init(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((4, 32, cfg.d_model), generator=g)
    (got, aux), (want, waux) = make_moe_apply_ep(m, cfg)(x, p, cfg), moe.moe_apply(
        x, p, cfg, capacity_factor=cfg.capacity_factor)
    r = moe.moe_route(x.reshape(128, -1), p, cfg, capacity_factor=cfg.capacity_factor)
    out.update(ep_err=float((got - want).abs().max()), aux_err=float(abs(aux - waux)),
               dropped=int((~r["keep"]).sum()))
finally:
    dist.destroy_process_group()
print(json.dumps(out), flush=True)
# past this point only the interpreter's teardown is left, in which gloo's
# threads have been seen to abort (std::terminate) once under a loaded
# machine after the group was destroyed: leave without it
os._exit(0)
"""


def test_mesh_is_lazy_and_matches_reference_helpers(tmp_path):
    """Importing ``launch.mesh`` initialises no process group and no CUDA
    context; then a one-rank gloo group (a ``file://`` store) and a (1, 1)
    CPU mesh: its axes and sizes are the reference's for the same names,
    a mesh with no model axis gets no decode override, and at world 1
    flash-decoding is ``chunked_attention`` and EP is ``moe_apply``, its
    capacity drops included."""
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_MESH_PROBE), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["lazy"] == [False, False]
    jm = jax.make_mesh((1, 1), ("data", "model"))
    assert tuple(out["data_axes"]) == jmesh.data_axes(jm)
    assert out["model_axis"] == jmesh.model_axis(jm)
    assert out["sizes"] == [jmesh.axis_size(jm, n) for n in (None, "data", "model",
                                                            ("data", "model"))]
    assert out["no_model"] is None
    assert out["decode_err"] == 0.0          # to the last bit: the same scan
    assert out["dropped"] > 0 and out["ep_err"] <= 1e-6 and out["aux_err"] <= 1e-7


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data", "model")),
                                        ((4,), ("model",)), ((4,), ("data",))],
                         ids=["pod", "multi-pod", "model-only", "data-only"])
def test_mesh_helpers_match_reference_on_production_shapes(shape, axes):
    """The helpers read only names and sizes: a stand-in for each mesh
    (the reference's ``axis_names`` and ``shape`` dict, the port's
    ``mesh_dim_names`` and ``shape`` tuple)."""
    ref = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    port = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    assert mesh.data_axes(port) == jmesh.data_axes(ref)
    assert mesh.model_axis(port) == jmesh.model_axis(ref)
    for names in (None, *axes, jmesh.data_axes(ref), axes):
        assert mesh.axis_size(port, names) == jmesh.axis_size(ref, names)


_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bool_): torch.bool, jnp.dtype(jnp.float32): torch.float32}


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_tree(v) for v in tree]
    return tuple(tree.shape), tree.dtype, getattr(tree, "device", None)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_match_reference(shape_name):
    """Every config: the keys, shapes and dtypes of the reference's
    ``ShapeDtypeStruct``s (decode: the caches through the model's cache
    shapes), every tensor on ``meta``."""
    assert set(SHAPES) == set(JSHAPES)
    for arch in list_archs():
        shp, jshp = SHAPES[shape_name], JSHAPES[shape_name]
        decode = shp.kind == "decode"
        got = _spec_tree(specs.input_specs(
            arch, shp, make_model(get_config(arch)) if decode else None))
        want = _spec_tree(jspecs.input_specs(
            arch, jshp, jmake_model(jget_config(arch)) if decode else None))
        leaves, jleaves = jax.tree.leaves(got, is_leaf=lambda t: isinstance(t, tuple)), \
            jax.tree.leaves(want, is_leaf=lambda t: isinstance(t, tuple))
        assert jax.tree.structure(got, is_leaf=lambda t: isinstance(t, tuple)) == \
            jax.tree.structure(want, is_leaf=lambda t: isinstance(t, tuple)), arch
        assert len(leaves) == len(jleaves) > 0
        for (s, dt, dev), (js, jdt, _) in zip(leaves, jleaves):
            assert s == js and dt == _DTYPES[jnp.dtype(jdt)], (arch, shape_name)
            assert dev == torch.device("meta"), (arch, shape_name)
