"""The port stands alone: importing it, or chip_smoke.py, loads neither
``jax`` nor the reference package ``repro``; and it never falls back to
the CPU on its own. The probe walks every module of the package, the
RRE and MCD-OS copies, the MoE, RG-LRU, xLSTM and shardctx models, and
the training slice (``data``, ``training``, ``launch.train``) and the
rest of ``launch`` (tuning, serve, mesh, specs, flash_decode, moe_ep)
included, with training on a mesh (``training.elastic``,
``training.data_parallel``) and every name of ``serving``: importing
``launch.serve`` runs nothing."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.data", "repro_torch.training", "repro_torch.training.checkpoint",
             "repro_torch.training.elastic", "repro_torch.training.data_parallel",
             "repro_torch.training.train_step", "repro_torch.models.layers",
             "repro_torch.models.moe", "repro_torch.models.shardctx", "repro_torch.serving",
             "repro_torch.launch.train", "repro_torch.launch.tuning", "repro_torch.launch.serve",
             "repro_torch.launch.mesh", "repro_torch.launch.specs",
             "repro_torch.launch.flash_decode", "repro_torch.launch.moe_ep"):
    assert name in names, name
import repro_torch.serving as serving
for name in serving.__all__:                      # the lazily loaded names too
    getattr(serving, name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src") + ":" + str(ROOT), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 78          # every subpackage and module was imported
    assert bad == "[]"


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""      # no result printed
