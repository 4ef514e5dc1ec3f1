"""How far the reduced xlstm-125m's parameter gradients lie apart in f32,
the port's against the reference's, by depth; and how far each lies from
the port computed in float64.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_grad_rounding.py

For 6 layers (one tile of the pattern) and 12 (the reduced config's two),
at B=1 x T=512 (the chunkwise mLSTM; ``tests/test_torch_flash_grad.py``'s
batch) and at B=4 x T=16 (``tests/test_torch_xlstm_parallel.py``'s first
batch, from ``tests/torch_train_ranks.py``), prints the largest gradient
difference of any leaf, each scaled to the reference's largest magnitude
(1 or more) as ``tests/test_torch_flash_grad.py`` scales it, and the
reference's largest gradient magnitude, for: the port against
``jax.grad`` op by op; ``jax.jit(jax.grad)`` against ``jax.grad`` op by op
(the reference's own spread between two associations); and each f32 side
against the port in float64 (``Tensor.float`` cast to float64 for the
run, and ``torch.zeros`` and ``torch.full`` asked for float32 give
float64, so every f32 step and state of the blocks is float64 too). A CPU
script: it imports JAX and the reference beside the port, as the tests do.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.models import from_jax_params, make_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
import torch_train_ranks  # noqa: E402

ARCH = "xlstm-125m"


def _batch(cfg, B, T):
    if (B, T) == (torch_train_ranks.B, torch_train_ranks.T):
        return torch_train_ranks.case_batches(cfg)[0]
    rng = np.random.default_rng(1)
    return {"labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "mask": rng.random((B, T)) < 0.8,
            "tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _port_grads(cfg, jp, batch, dtype):
    model = make_model(cfg, param_dtype=dtype, compute_dtype=dtype)
    params = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    flat = list(_flat(params))
    inputs = [t.detach().to(dtype).requires_grad_() for _, t in flat]
    it = iter(inputs)
    tree = jax.tree.map(lambda t: next(it), params)
    as_torch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if dtype == torch.float64:
        # every f32 cast and f32 state of the blocks in float64 for the run
        real = torch.Tensor.float, torch.zeros, torch.full

        def wide(fn):
            def make(*a, dtype=None, **kw):
                return fn(*a, dtype=torch.float64 if dtype == torch.float32 else dtype, **kw)
            return make

        torch.Tensor.float = lambda self, *a, **kw: self.double()
        torch.zeros, torch.full = wide(real[1]), wide(real[2])
        try:
            loss, _ = model.loss(tree, as_torch)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        finally:
            torch.Tensor.float, torch.zeros, torch.full = real
    else:
        loss, _ = model.loss(tree, as_torch)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return {path: g.double().numpy() for (path, _), g in zip(flat, grads)}


def _worst(a, b, scale):
    return max((float(np.abs(a[p] - b[p]).max()) / max(1.0, float(np.abs(scale[p]).max())), p)
               for p in scale)


def main() -> None:
    for (B, T), n_layers in ((s, n) for s in ((1, 512), (4, 16)) for n in (6, 12)):
        jcfg = dataclasses.replace(jget_config(ARCH).reduced(), n_layers=n_layers)
        cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers)
        jm = jmake_model(jcfg, param_dtype=jnp.float32, compute_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(jcfg, B, T)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss(q):
            return jm.loss(q, jb)[0]

        ref = {p: np.asarray(g, np.float64) for p, g in _flat(jax.grad(loss)(jp))}
        ref_jit = {p: np.asarray(g, np.float64) for p, g in _flat(jax.jit(jax.grad(loss))(jp))}
        port = _port_grads(cfg, jp, batch, torch.float32)
        port64 = _port_grads(cfg, jp, batch, torch.float64)
        big = max(float(np.abs(g).max()) for g in ref.values())
        print(f"{n_layers} layers, B={B} T={T} (largest gradient magnitude {big:.3g}):")
        for what, a, b in (("port vs jax.grad", port, ref),
                           ("jax.jit(grad) vs jax.grad", ref_jit, ref),
                           ("port f32 vs port f64", port, port64),
                           ("jax.grad f32 vs port f64", ref, port64)):
            err, path = _worst(a, b, ref)
            print(f"  {what:28s} {err:.3g}  ({path})")


if __name__ == "__main__":
    main()
