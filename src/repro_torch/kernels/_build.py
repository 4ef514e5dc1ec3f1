"""Builds the kernels of ``csrc/`` and loads them with ``ctypes``.

Two routes, both into shared libraries with a plain C interface:

(a) ``nvcc``: each ``csrc/<name>.cu`` for the card::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>_<hash>.so csrc/<name>.cu

(b) ``g++``: a kernel whose body is host-and-device code in a header
(the lane engine, ``csrc/lane_engine.cuh``) also has a host translation
unit ``csrc/<name>_host.cpp``, built for the CPU::

    g++ -std=c++17 -O2 -shared -fPIC -o _build/<name>_host_<hash>.so \\
        csrc/<name>_host.cpp

That host build is the kernel's plain version: the CPU tests run the
body the card runs. Route (b) needs no CUDA toolkit.

Each library is named after a hash of its source, the shared headers and
the flags (as the reference names its C engine), so an edited kernel is
rebuilt and an unchanged one is loaded as it is. Libraries are built at
first use, into ``kernels/_build/`` (ignored by git); :func:`build` starts
one ``nvcc`` per missing source, all at once. A missing compiler or a
failed build raises: nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("paged_attention", "shared_prefix_attention", "flash_attention",
           "flash_attention_bwd", "lane_engine")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 600
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build every library of ``names`` that is missing, one ``nvcc`` each,
    run in parallel. Returns ``{name: ptxas report}`` for the libraries
    built by this call. Raises with the compiler's output on a failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f".{so.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for name, (so, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        if proc.returncode == 0 and tmp.exists():
            os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
            reports[name] = log
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError(
        "no C++ compiler found (looked for $CXX, g++, c++); the host build "
        "of the kernels cannot be made"
    )


def host_library_path(name: str) -> Path:
    """Where the host library of ``csrc/<name>_host.cpp`` is (or will be)
    built."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update((CSRC / f"{name}_host.cpp").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}_host_{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>_host.cpp`` (route (b)),
    built with ``g++`` first if missing. A failed build raises."""
    lib = _host_libs.get(name)
    if lib is not None:
        return lib
    so = host_library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}.so")
        cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}_host.cpp")]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            if out.returncode != 0 or not tmp.exists():
                raise RuntimeError(
                    f"host build of {name} failed (exit {out.returncode}):\n"
                    f"{out.stdout}{out.stderr}"
                )
            os.replace(tmp, so)   # atomic: a concurrent builder's copy is the same
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    _host_libs[name] = lib
    return lib
