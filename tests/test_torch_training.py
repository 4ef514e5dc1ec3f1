"""The port's training substrate on the CPU: ``tests/test_training.py``'s
tests on the port (optimizer, train step, checkpointing, compression,
fault tolerance; its data test is in ``tests/test_torch_data.py``), at its
reduced stablelm-1.6b with ``SyntheticLMData(vocab, 64, 4, seed=3)``; then
the port against the reference on the same NumPy inputs: ``adamw_update``
and ``compress_grads`` (f32, atol 1e-6; int8 codes equal), two
``train_step``s from the same converted parameters and batches (f32/f32:
atol 1e-4; bf16 compute: the bound stated at the test), and the launcher
with a simulated failure and a resume.

The port's step updates its state in place (the reference's launcher
donates it), so a test that steps one state twice copies it first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.models import make_model as jmake_model
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.compression import CompressionConfig as JCompressionConfig
from repro.training.compression import compress_grads as jcompress_grads
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.train_step import init_train_state as jinit_train_state
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.models import from_jax_params, make_model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.compression import (
    CompressionConfig,
    compress_grads,
    compression_init,
)
from repro_torch.training.elastic import reshard_state
from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_lr
from repro_torch.training.train_step import init_train_state
from repro_torch.training.tree import leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)


def _batch(data):
    return {k: torch.from_numpy(v) for k, v in data.next_batch().items()}


def _setup(arch="stablelm-1.6b", **tkw):
    cfg = get_config(arch).reduced()
    model = make_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100), **tkw)
    step = make_train_step(model, tcfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    data = SyntheticLMData(cfg.vocab_size, 64, 4, seed=3)
    return cfg, model, tcfg, step, state, data


def _copy(tree):
    return tree_map(torch.clone, tree)


def test_loss_decreases():
    cfg, model, tcfg, step, state, data = _setup()
    losses = []
    for _ in range(30):
        state, m = step(state, _batch(data))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    assert np.isfinite(losses).all()


def test_grad_accumulation_matches_full_batch():
    cfg, model, _, _, state, data = _setup()
    batch = _batch(data)
    t1 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=1)
    t4 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=4)
    s1, _ = make_train_step(model, t1)(_copy(state), batch)
    s4, _ = make_train_step(model, t4)(_copy(state), batch)
    # same total gradient => same updated params (up to fp assoc.)
    worst = max(float((a - b).abs().max())
                for a, b in zip(leaves(s1["params"]), leaves(s4["params"])))
    assert worst < 5e-3


def test_dropped_gradients_are_freed_without_the_garbage_collector():
    """The gradients ``make_grad_fn`` returns (built by ``tree.unflatten``)
    are freed as soon as the caller drops them: no reference cycle holds
    them until the garbage collector runs (on the card, a deepseek-v2
    layer's 20 GB of them)."""
    import gc
    import weakref

    from repro_torch.training.train_step import make_grad_fn
    from repro_torch.training.tree import unflatten

    cfg, model, tcfg, _, state, data = _setup()
    was = gc.isenabled()
    gc.disable()
    try:
        _, _, grads = make_grad_fn(model, tcfg)(state["params"], _batch(data))
        refs = [weakref.ref(g) for g in leaves(grads)]
        del grads
        assert not any(r() is not None for r in refs)
        tree = unflatten({"a": [0, 1], "b": 2}, [torch.ones(3) for _ in range(3)])
        refs = [weakref.ref(t) for t in leaves(tree)]
        del tree
        assert not any(r() is not None for r in refs)
    finally:
        if was:
            gc.enable()


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(cosine_lr(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(cosine_lr(cfg, torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(cosine_lr(cfg, torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)


def test_checkpoint_roundtrip_bitexact(tmp_path):
    cfg, model, tcfg, step, state, data = _setup()
    ck = Checkpointer(tmp_path)
    for _ in range(3):
        state, _ = step(state, _batch(data))
    ck.save(3, state, {"step": 3, "data": data.state()})
    restored, extras = ck.restore(None, state)
    assert extras["step"] == 3
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_roundtrip_bf16_and_device_move(tmp_path):
    """A bf16 leaf (stored as its 16-bit patterns) and an int leaf come
    back bit for bit; ``reshard_state`` moves a state between devices."""
    gen = torch.Generator().manual_seed(1)
    tree = {"w": torch.randn((3, 5), generator=gen).bfloat16(),
            "z": {"step": torch.tensor(7, dtype=torch.int32), "f": torch.randn(4, generator=gen)}}
    ck = Checkpointer(tmp_path)
    ck.save_async(1, tree, {"step": 1})
    back, _ = ck.restore(None, reshard_state(tree, "cpu"))
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_save_async_is_not_changed_by_the_next_step(tmp_path):
    """save_async copies a host state before it returns: the train step
    updates the state in place while the thread is still writing, and the
    checkpoint keeps the values of the step it was taken at."""
    import threading

    gen = torch.Generator().manual_seed(2)
    tree = {"w": torch.randn((3, 5), generator=gen),
            "m": {"b": torch.randn(4, generator=gen).bfloat16()}}
    saved = tree_map(torch.clone, tree)
    ck = Checkpointer(tmp_path)
    write, go = ck._save_impl, threading.Event()

    def held_write(*args):
        go.wait()  # the file IO starts only after the in-place update
        return write(*args)

    ck._save_impl = held_write
    ck.save_async(1, tree, {"step": 1})
    for leaf in leaves(tree):
        leaf.add_(1.0)
    go.set()
    ck.wait()
    back, _ = ck.restore(None, tree)
    for a, b in zip(leaves(saved), leaves(back)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_resume_equals_uninterrupted_run(tmp_path):
    """5 steps + ckpt + restore + 5 steps == 10 straight steps."""
    def run(n_steps, ckpt_at=None, resume_from=None):
        cfg, model, tcfg, step, state, data = _setup()
        ck = Checkpointer(tmp_path / "ck")
        start = 0
        if resume_from is not None:
            state, extras = ck.restore(None, state)
            data.restore(extras["data"])
            start = extras["step"]
        for s in range(start, n_steps):
            state, _ = step(state, _batch(data))
            if ckpt_at is not None and s + 1 == ckpt_at:
                ck.save(s + 1, state, {"step": s + 1, "data": data.state()})
        return state

    s_straight = run(10)
    run(5, ckpt_at=5)
    s_resumed = run(10, resume_from=5)
    for a, b in zip(leaves(s_straight), leaves(s_resumed)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp staging dir must never be visible as a checkpoint."""
    ck = Checkpointer(tmp_path)
    tree = {"w": torch.ones(4)}
    ck.save(1, tree)
    (tmp_path / "step_00000002.tmp").mkdir()  # simulated dead writer
    assert ck.latest_step() == 1
    restored, _ = ck.restore(None, tree)
    np.testing.assert_array_equal(restored["w"].numpy(), np.ones(4))


def test_checkpoint_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]


def test_checkpoint_manifest_matches_reference_layout(tmp_path):
    """The same tree saved by both packages: the same leaf files, paths
    (jax's keystr, keys sorted), shapes and dtypes."""
    import json

    from repro.training.checkpoint import Checkpointer as JCheckpointer

    arrays = {"b": {"z": np.ones((2, 3), np.float32), "a": np.arange(4, dtype=np.int32)},
              "a": [np.zeros(5, np.float32), np.ones(1, np.float32)]}
    JCheckpointer(tmp_path / "ref").save(1, jax.tree.map(jnp.asarray, arrays))
    Checkpointer(tmp_path / "port").save(1, tree_map(torch.from_numpy, arrays))
    man = [json.loads((tmp_path / d / "step_00000001" / "MANIFEST.json").read_text())["leaves"]
           for d in ("ref", "port")]
    assert man[0] == man[1]
    for e in man[0]:
        np.testing.assert_array_equal(
            np.load(tmp_path / "ref" / "step_00000001" / e["file"]),
            np.load(tmp_path / "port" / "step_00000001" / e["file"]))


def test_compression_error_feedback_unbiased():
    """EF quantization: accumulated residuals keep the long-run sum of
    transmitted gradients equal to the true sum."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)) for _ in range(20)]
    res = compression_init({"w": torch.zeros((128, 64))})
    cfg = CompressionConfig(bits=8, min_size=1)
    sent = torch.zeros((128, 64))
    for g in g_true:
        out, res, _ = compress_grads({"w": g}, res, cfg)
        sent = sent + out["w"]
    gap = (sent - sum(g_true)).abs()
    # residual bounds the gap: |sum sent - sum true| == |final residual|
    np.testing.assert_allclose(gap.numpy(), res["w"].abs().numpy(), atol=1e-4)
    assert float(gap.max()) < 0.1  # one quantization step worth


def test_compression_training_parity():
    losses = {}
    for comp in (None, CompressionConfig(bits=8, min_size=1)):
        cfg, model, tcfg, step, state, data = _setup(compression=comp)
        ls = []
        for _ in range(20):
            state, m = step(state, _batch(data))
            ls.append(float(m["loss"]))
        losses[bool(comp)] = np.mean(ls[-5:])
    assert abs(losses[True] - losses[False]) < 0.3


def test_straggler_and_failure_tools():
    from repro_torch.training.elastic import (
        FailureInjector,
        SimulatedNodeFailure,
        StragglerMonitor,
    )

    mon = StragglerMonitor(min_samples=5, factor=2.0)
    for s in range(10):
        assert not mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)
    inj = FailureInjector([3])
    inj.maybe_fail(2)
    with pytest.raises(SimulatedNodeFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)  # one-shot


# -- against the reference ----------------------------------------------------

def test_adamw_update_matches_reference():
    """Two AdamW steps on the same NumPy parameters and gradients (one
    gradient large enough to be clipped), f32: atol 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": {"c": (17,), "d": (3, 5, 7)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: (rng.standard_normal(s) * sc).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple)) for sc in (0.01, 3.0)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    jst = {"mu": jax.tree.map(jnp.zeros_like, jp), "nu": jax.tree.map(jnp.zeros_like, jp),
           "step": jnp.zeros((), jnp.int32)}
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tst = adamw_init(tp)
    for g in grads:
        jp, jst, jm = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        tp, tst, tm = adamw_update(tp, tree_map(torch.from_numpy, g), tst, cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 2
    for name in ("mu", "nu"):
        for a, b in zip(leaves(tst[name]), jax.tree.leaves(jst[name])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_compress_grads_matches_reference():
    """Three steps of error feedback on the same NumPy gradients: the
    dequantized gradients and residuals within 1e-6, the int8 codes
    equal, the small leaf passed through."""
    rng = np.random.default_rng(1)
    grads = [{"w": rng.standard_normal((96, 64)).astype(np.float32),
              "s": rng.standard_normal(8).astype(np.float32)} for _ in range(3)]
    cfg, jcfg = CompressionConfig(bits=8, min_size=64), JCompressionConfig(bits=8, min_size=64)
    jr = {"w": jnp.zeros((96, 64)), "s": jnp.zeros(8)}
    tr = compression_init({"w": torch.zeros((96, 64)), "s": torch.zeros(8)})
    for g in grads:
        res_before = tr["w"].numpy().copy()
        jg, jr, jm = jcompress_grads(jax.tree.map(jnp.asarray, g), jr, jcfg)
        tg, tr, tm = compress_grads(tree_map(torch.from_numpy, g), tr, cfg)
        np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]), atol=1e-6)
        np.testing.assert_allclose(tr["w"].numpy(), np.asarray(jr["w"]), atol=1e-6)
        np.testing.assert_array_equal(tg["s"].numpy(), g["s"])
        gf = g["w"] + res_before
        scale = np.float32(np.abs(gf).max() / np.float32(127))
        np.testing.assert_array_equal(np.round(tg["w"].numpy() / scale),
                                      np.round(np.asarray(jg["w"]) / scale))
        np.testing.assert_allclose(float(tm["compress_rel_err"]), float(jm["compress_rel_err"]),
                                   rtol=1e-5)


def _two_steps(compute):
    """Two train steps of the reduced stablelm in both packages from the
    same parameters and batches: (port losses, reference losses, port
    params, reference params)."""
    jcfg, cfg = jget_config("stablelm-1.6b").reduced(), get_config("stablelm-1.6b").reduced()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jtc = JTrainConfig(optimizer=JAdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100),
                       compute_dtype=jdt)
    tc = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100),
                     compute_dtype=tdt)
    jm = jmake_model(jcfg, compute_dtype=jdt)
    jstate = jinit_train_state(jm, jax.random.PRNGKey(0), jtc)
    m = make_model(cfg, compute_dtype=tdt)
    params = from_jax_params(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    start = tree_map(torch.clone, params)
    state = {"params": params, "opt": adamw_init(params)}
    jstep, step = jax.jit(jmake_train_step(jm, jtc)), make_train_step(m, tc)
    data = JSyntheticLMData(cfg.vocab_size, 64, 4, seed=3)
    losses, jlosses = [], []
    for _ in range(2):
        b = data.next_batch()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
    return losses, jlosses, state["params"], jstate["params"], start


def _param_pairs(tp, jp):
    flat_t = dict(_leaves_with_paths(tp))
    flat_j = dict(_leaves_with_paths(jax.tree.map(np.asarray, jp)))
    assert set(flat_t) == set(flat_j)
    return [(k, flat_t[k].float().numpy(), flat_j[k]) for k in sorted(flat_t)]


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_two_train_steps_match_reference_f32():
    losses, jlosses, tp, jp, _ = _two_steps("float32")
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    for path, a, b in _param_pairs(tp, jp):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=path)


def test_two_train_steps_match_reference_bf16_compute():
    """The default mixed precision (f32 masters, bf16 compute). The two
    frameworks round to bf16 at other places (bf16 products, the residual
    stream), so the losses are held to 2e-2 (about 2^-8 of a loss near 6,
    one bf16 step; 7e-4 seen). Adam's first steps move an element by about
    lr_t whatever its gradient's size, so an element whose gradient is near
    zero may move the other way: no element may differ by more than 2 x the
    sum of the two steps' lr, and each tensor's two-step change must agree
    with the reference's within 15% in relative L2 (0.3% to 11.2% seen on
    this seed, the embedding's rare rows the most)."""
    losses, jlosses, tp, jp, p0 = _two_steps("bfloat16")
    np.testing.assert_allclose(losses, jlosses, atol=2e-2)
    cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    moved = float(cosine_lr(cfg, torch.tensor(1)) + cosine_lr(cfg, torch.tensor(2)))
    start = dict(_leaves_with_paths(p0))
    for path, a, b in _param_pairs(tp, jp):
        assert np.abs(a - b).max() <= 2 * moved + 1e-6, path
        d_t, d_j = a - start[path].numpy(), b - start[path].numpy()
        assert np.linalg.norm(d_t - d_j) <= 0.15 * np.linalg.norm(d_j), path


def test_launcher_recovers_from_a_failure_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU, 5 steps with a checkpoint after
    each: a failure injected at step 2 is recovered from the step-2
    checkpoint; then, LATEST set back to step 3 (a run that stopped there),
    ``--resume`` runs steps 3 and 4 again. Both end where 5 uninterrupted
    steps end, bit for bit."""
    base = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2", "--seq", "32", "--steps", "5",
            "--device", "cpu", "--log-every", "1"]
    seen = []
    rc = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "1",
                                   "--simulate-failures", "2"],
                           on_step=lambda s, loss, dt: seen.append(s))
    assert rc == 0 and seen == [0, 1, 2, 3, 4]
    assert "[failure] injected failure at step 2" in capsys.readouterr().out
    assert launch_train.main(base + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    like = {"params": make_model(get_config("qwen3-1.7b").reduced()).init(
        torch.Generator().manual_seed(0))}
    like["opt"] = adamw_init(like["params"])
    straight, _ = Checkpointer(tmp_path / "b").restore(5, like)
    recovered, _ = Checkpointer(tmp_path / "a").restore(5, like)
    (tmp_path / "a" / "LATEST").write_text("step_00000003")
    capsys.readouterr()
    assert launch_train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--resume"]) == 0
    assert "[resume] restored step 3" in capsys.readouterr().out
    resumed, _ = Checkpointer(tmp_path / "a").restore(5, like)
    for x, y, z in zip(leaves(straight), leaves(recovered), leaves(resumed)):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
        torch.testing.assert_close(z, x, rtol=0, atol=0)
    assert not list((tmp_path / "a").glob("*.tmp"))


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_config_fields_match_reference():
    """The port's configs keep the reference's defaults, bf16 compute
    included."""
    tc, jtc = TrainConfig(), JTrainConfig()
    assert dataclasses.asdict(tc.optimizer) == dataclasses.asdict(jtc.optimizer)
    assert tc.microbatches == jtc.microbatches and tc.compression is None
    assert tc.compute_dtype == torch.bfloat16 and jtc.compute_dtype == jnp.bfloat16
