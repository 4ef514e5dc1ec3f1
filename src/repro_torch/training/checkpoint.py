"""Fault-tolerant checkpointing: async, atomic, resumable (the reference's
``repro.training.checkpoint``, its layout and commit protocol).

Layout (one directory per step):

    ckpt_dir/
      step_00000123/
        MANIFEST.json       # leaf paths, shapes, dtypes, step, extras
        leaf_00000.npy ...  # one file per tree leaf
      step_00000123.tmp/    # staging dir; renamed on commit
      LATEST                # text file: last committed step directory

Leaves are numbered in ``jax.tree_util``'s order (dict keys sorted, see
``tree.py``), and their paths are written as its ``keystr``, so a
manifest reads as the reference's does. NumPy has no bfloat16: a bf16
leaf is stored as its 16-bit patterns (``uint16``) and the manifest says
``"dtype": "bfloat16"``; restore views the bits as bf16 again.

Crash-safety: writes go to ``.tmp`` and are committed by ``os.replace``
of the directory and then of LATEST, so a checkpoint is either fully
present or invisible. ``save_async`` copies the tensors synchronously,
into new host memory even for a state already on the CPU (the next step
updates the state in place), and writes the files on a thread; the loop
joins it before the next save.

Restore loads each leaf to the host, checks its shape against the target
tree and places it: against ``shardings`` (the reference's argument: one
spec or a tree of them, as ``elastic.reshard_state`` takes), else on
``device``, else as the target leaf is placed (its device, or its mesh
and placements for a DTensor). A state saved on the card restores onto
the CPU and back, and a state saved on a mesh onto a mesh of another
size (``elastic.py``).

A state that holds DTensors is saved by every rank of the mesh together:
each gathers every leaf (``full_tensor``, collective, in leaf order),
global rank 0 alone writes the files and commits, and every rank then
waits at a barrier of the default group: ``save`` before it returns,
``save_async`` when it is joined (``wait``, which ``restore`` calls
first), so that no rank reads ``LATEST`` before rank 0 wrote it. The
reference has one controller and needs none of this.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .elastic import check_specs, is_dtensor, place_leaf, sharding_of, specs_for
from .tree import flatten_with_paths, unflatten


def _to_host(t: torch.Tensor) -> np.ndarray:
    # A copy even when t is already on the host: the train step updates the
    # state in place, and an async save must not see the next step's values.
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._barrier = False          # a save of a mesh state not yet met at the barrier

    # -- write ----------------------------------------------------------
    def _host(self, tree):
        """The leaves on the host, and whether this rank writes them: a
        state holding DTensors is written by global rank 0 alone."""
        pairs = flatten_with_paths(tree)
        meshed = any(is_dtensor(leaf) for _, leaf in pairs)
        host = [(path, _to_host(leaf), str(leaf.dtype).replace("torch.", ""))
                for path, leaf in pairs]
        self._barrier = meshed
        return host, not meshed or dist.get_rank() == 0

    def save(self, step: int, tree: Any, extras: Optional[dict] = None) -> Path:
        self.wait()
        host, writes = self._host(tree)
        if writes:
            self._save_impl(step, host, extras or {})
        self.wait()
        return self.dir / f"step_{step:08d}"

    def save_async(self, step: int, tree: Any, extras: Optional[dict] = None) -> None:
        """The device -> host copy happens now (the next step updates the
        state in place); the file IO on a thread."""
        self.wait()
        host, writes = self._host(tree)
        if writes:
            self._thread = threading.Thread(
                target=self._save_impl, args=(step, host, extras or {}), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Joins a save in flight; after a save of a mesh state, every rank
        waits here until rank 0 has committed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _save_impl(self, step: int, host_leaves, extras: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extras": extras, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype})
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic commit 1
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        os.replace(latest_tmp, self.dir / "LATEST")  # atomic commit 2
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    # -- read -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        name = latest.read_text().strip()
        if not (self.dir / name / "MANIFEST.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, step: Optional[int], target_tree: Any, shardings: Any = None,
                device=None) -> Tuple[Any, dict]:
        """The checkpoint of ``step`` (None: the latest) in the structure of
        ``target_tree``, each leaf placed against ``shardings`` (one spec or
        a tree of them), else on ``device``, else as the target leaf is;
        and the extras saved with it. A save in flight is joined first.
        Placing a leaf on a mesh is collective: every rank of it calls
        this."""
        self.wait()
        pairs = flatten_with_paths(target_tree)
        specs = specs_for(target_tree, shardings) if shardings is not None else [None] * len(pairs)
        check_specs(pairs, specs)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "MANIFEST.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for (path, leaf), spec in zip(pairs, specs):
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            arr = np.load(cdir / entry["file"])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            if spec is None:
                spec = device or (sharding_of(leaf) if is_dtensor(leaf) else leaf.device)
            out.append(place_leaf(_from_host(arr, entry["dtype"]), spec, path))
        return unflatten(target_tree, out), manifest["extras"]

