"""Names the reference exports that the port must export too: every name
of ``repro.serving.__all__`` on ``repro_torch.serving`` (the trace and
cost names loaded on first use, as the reference loads them), each the
port module's own object; and the GELU MLP of ``models.layers`` against
the reference's on parameters carried across (f32, 1e-6)."""

import importlib

import jax
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.models import layers as jlayers
from repro_torch.models import layers
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)


@pytest.mark.parametrize("name", jserving.__all__)
def test_serving_name_resolves_to_the_port_module(name):
    serving = importlib.import_module("repro_torch.serving")
    assert name in serving.__all__
    obj = getattr(serving, name)
    home = importlib.import_module(jserving._LAZY[name].replace(".", "repro_torch.serving.", 1))
    assert obj is getattr(home, name)
    assert obj.__module__.startswith("repro_torch.")


def test_serving_unknown_name_raises():
    import repro_torch.serving as serving

    with pytest.raises(AttributeError):
        serving.not_a_name    # noqa: B018


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 16)])
def test_gelu_mlp_matches_reference(shape):
    p = jax.tree.map(np.array, jlayers.gelu_mlp_init(jax.random.PRNGKey(0), 16, 40))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jlayers.gelu_mlp_apply(x, p))
    got = layers.gelu_mlp_apply(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_gelu_mlp_init_shapes():
    p = layers.gelu_mlp_init(torch.Generator().manual_seed(0), 16, 40, lead=(3,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {"w_up": (3, 16, 40), "w_down": (3, 40, 16)}
    assert float(p["w_up"].std()) == pytest.approx(16 ** -0.5 * 0.88, rel=0.15)
