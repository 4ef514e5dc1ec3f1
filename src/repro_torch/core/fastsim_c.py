"""ctypes binding for the C hot loop of the array simulation engine.

``_fastsim_c.c`` (a line-for-line port of the verified Python loops in
:mod:`repro_torch.core.fastsim`) is compiled on first use with the system C
compiler into a content-addressed shared object under
``src/repro_torch/core/_cbuild/`` (falling back to a temp dir, then — if no
compiler is available — to the pure-Python loops). The build is
concurrency-safe: each builder compiles to a unique temp name and
atomically ``os.replace``s it into place, so parallel processes (e.g.
pytest-xdist workers or simultaneous benchmark runs) race harmlessly —
whoever finishes first wins and everyone loads a complete ``.so``. No
third-party packages involved: numpy buffers go straight through ctypes
pointers.

The native entry points are *chunk drivers*: :class:`FlatChunkRunner`
and :class:`NoshareChunkRunner` keep all engine state resident across
``feed(proxies, objects)`` calls, so a request stream can be consumed
chunk by chunk without ever materializing the full trace (the Section
VI-C streaming path). The flat runner's per-(proxy, object) state is a
sparse touched-set — objects get accumulator slots on first entry into
any list, and the slot arrays grow geometrically on demand.

This binding layer is the trust boundary for the C code's index
arithmetic: every ``feed`` validates its inputs before crossing into
C, so proxy ids in ``P`` are always ``< J`` and object ids in ``O``
are always ``< N`` by the time the chunk drivers see them. The
``cbounds`` analyzer rule takes exactly those two facts as axioms
(the ``cbounds: P[] < J`` / ``O[] < N`` contract comments at the top
of ``_fastsim_c.c``) and proves every other array subscript in the C
file from capacity annotations alone — keep the validation here in
sync with those contract comments.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
import uuid
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC = Path(__file__).with_name("_fastsim_c.c")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_error: Optional[Exception] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

# out_scalars layout — must match the enum in _fastsim_c.c
SC_PHYS, SC_GHEAD, SC_GTAIL, SC_NGHOSTS, SC_TSTART = 0, 1, 2, 3, 4
SC_NHITLIST, SC_NHITCACHE, SC_NMISS = 5, 6, 7
SC_NSETS, SC_NPRIM, SC_NRIP, SC_NBATCH = 8, 9, 10, 11
SC_NSLOTS, SC_SETSSINCE = 12, 13
SC_COUNT = 14

# Must match fastsim.HIST_BUCKETS (identical clamping across backends).
HIST_LEN = 1024

# Initial touched-set capacity of the flat runner (grows x2 on demand,
# capped at N).
INITIAL_SLOT_CAP = 1 << 16


_KNOWN_SANITIZERS = ("address", "undefined")


def _sanitizers() -> tuple:
    """Sanitizers requested via ``REPRO_C_SANITIZE`` (sorted tuple).

    ``REPRO_C_SANITIZE=address,undefined`` builds the C hot loop under
    ASan/UBSan — the nightly ``c-sanitize`` CI job runs the fastsim and
    streaming suites this way. Unknown names fail loudly rather than
    silently running unsanitized.
    """
    raw = os.environ.get("REPRO_C_SANITIZE", "").strip()
    if not raw:
        return ()
    sans = tuple(sorted({t.strip() for t in raw.split(",") if t.strip()}))
    unknown = [s for s in sans if s not in _KNOWN_SANITIZERS]
    if unknown:
        raise ValueError(
            f"REPRO_C_SANITIZE: unknown sanitizer(s) {unknown}; "
            f"supported: {', '.join(_KNOWN_SANITIZERS)}"
        )
    return sans


def _san_cflags(sans: tuple) -> list:
    """Extra CFLAGS for the requested sanitizers."""
    if not sans:
        return []
    flags = [
        f"-fsanitize={','.join(sans)}",
        "-fno-omit-frame-pointer",
        "-g",
    ]
    if "undefined" in sans:
        flags.append("-fno-sanitize-recover=undefined")
    return flags


def _fail(sans: tuple, why: str) -> Optional[ctypes.CDLL]:
    """Unavailability outcome: silent Python fallback normally, loud
    error when a sanitized build was explicitly requested — a sanitize
    CI run that quietly fell back to the Python loops would test
    nothing. The error is cached so every later call re-raises."""
    global _load_error
    if not sans:
        return None
    _load_error = RuntimeError(
        f"REPRO_C_SANITIZE={','.join(sans)} requested but the sanitized "
        f"C backend is unavailable ({why}); ASan builds also need the "
        "sanitizer runtime preloaded into the host interpreter, e.g. "
        'LD_PRELOAD="$(gcc -print-file-name=libasan.so) '
        '$(gcc -print-file-name=libstdc++.so)"'
    )
    raise _load_error


def _so_name(tag: str, sans: tuple) -> str:
    """Content-addressed .so name; the sanitizer suffix keeps sanitized
    and plain builds of the same source coexisting in one cache dir."""
    suffix = "".join(f"_{s}" for s in sans)
    return f"fastsim_{tag}{suffix}.so"


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if not cc:
            continue
        try:
            subprocess.run(
                [cc, "--version"], capture_output=True, check=True, timeout=30
            )
            return cc
        except Exception:
            continue
    return None


def _build_so(
    cc: str, src: Path, dest_dir: Path, name: str, extra_cflags=()
) -> Path:
    """Compile ``src`` into ``dest_dir/name``, safely under concurrency.

    The object is compiled to a unique temp name (pid + random suffix —
    two builders never share a temp file) and atomically renamed into
    place, so a concurrent loader either sees no file or a complete one.
    If this builder loses the race (or its compile fails after a winner
    appeared), the winner's artifact is returned.
    """
    dest_dir.mkdir(parents=True, exist_ok=True)
    so = dest_dir / name
    if so.exists():
        return so
    tmp = dest_dir / f".{name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    try:
        subprocess.run(
            [cc, "-O2", *extra_cflags, "-shared", "-fPIC", "-o", str(tmp),
             str(src)],
            capture_output=True,
            check=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    except BaseException:
        if so.exists():  # someone else won while we were compiling
            return so
        raise
    finally:
        try:
            tmp.unlink()
        except OSError:
            pass
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        if _load_error is not None:
            raise _load_error
        return _lib
    _tried = True
    sans = _sanitizers()  # unknown names raise before anything builds
    try:
        src = _SRC.read_bytes()
    except OSError:
        return _fail(sans, "C source _fastsim_c.c is unreadable")
    tag = hashlib.sha256(src).hexdigest()[:16]
    name = _so_name(tag, sans)
    cand_dirs = [
        _SRC.parent / "_cbuild",
        Path(tempfile.gettempdir()) / "repro_torch_fastsim_cbuild",
    ]
    for d in cand_dirs:
        so = d / name
        if so.exists():
            try:
                _lib = ctypes.CDLL(str(so))
                _configure(_lib)
                return _lib
            except OSError:
                continue
    cc = _compiler()
    if cc is None:
        return _fail(sans, "no C compiler found")
    last: Optional[Exception] = None
    for d in cand_dirs:
        try:
            so = _build_so(cc, _SRC, d, name, _san_cflags(sans))
            _lib = ctypes.CDLL(str(so))
            _configure(_lib)
            return _lib
        except Exception as e:
            last = e
            continue
    return _fail(sans, f"build/load failed: {last!r}")


def _configure(lib: ctypes.CDLL) -> None:
    lib.drive_chunk.restype = ctypes.c_int64
    lib.drive_chunk.argtypes = [
        ctypes.c_int64, ctypes.c_int64,                  # idx0, n_chunk
        ctypes.c_int64, ctypes.c_int64,                  # J, N
        _I32P, _I64P,                                    # P, O
        _I64P, _I64P, _I64P, _I64P,                      # lengths, b, bhat, share
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # scale, B, ghost
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # warmup, ripple_from, batch
        _I64P, _I64P,                                    # head, tail
        _U64P, _I64P, _I64P,                             # hmask, length, vlen
        _I64P, _I64P, _U8P,                              # gnxt, gprv, isghost
        _I64P, _I64P, ctypes.c_int64,                    # slot, slot_key, slot_cap
        _I64P, _I64P, _I64P, _I64P,                      # nxt, prv, res_since, tot_time
        _I64P, _I64P, _I64P,                             # sc, hits_p, reqs_p
        _I64P, ctypes.c_int64,                           # hist, hist_len
    ]
    lib.noshare_chunk.restype = ctypes.c_int64
    lib.noshare_chunk.argtypes = [
        ctypes.c_int64, ctypes.c_int64,                  # idx0, n_chunk
        ctypes.c_int64, ctypes.c_int64,                  # J, N
        _I32P, _I64P,                                    # P, O
        _I64P, _I64P,                                    # lengths, b
        ctypes.c_int64,                                  # warmup
        _I64P, _I64P, _I64P, _I64P,                      # nxt, prv, head, tail
        _U8P, _I64P,                                     # inlist, used
        _I64P, _I64P,                                    # res_since, tot_time
        _I64P, _I64P, _I64P,                             # sc, hits_p, reqs_p
    ]


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _check_ids(P: np.ndarray, O: np.ndarray, J: int, N: int) -> None:
    """Enforce the C contract at the binding boundary: proxy ids in
    ``[0, J)`` and object ids in ``[0, N)``. These are the two axioms
    (``cbounds: P[] < J`` / ``O[] < N``) every other bound proof in
    ``_fastsim_c.c`` rests on — the C side never re-checks them."""
    if len(P) and (int(P.min()) < 0 or int(P.max()) >= J):
        raise ValueError(
            f"proxy ids must lie in [0, {J}); got "
            f"[{int(P.min())}, {int(P.max())}]"
        )
    if len(O) and (int(O.min()) < 0 or int(O.max()) >= N):
        raise ValueError(
            f"object ids must lie in [0, {N}); got "
            f"[{int(O.min())}, {int(O.max())}]"
        )


class FlatChunkRunner:
    """Incremental native driver for the flat shared-LRU variant.

    ``feed(proxies, objects)`` consumes one chunk of the request stream
    (engine state stays resident in the caller-owned numpy buffers
    between calls); ``finish(n_total)`` closes open residence intervals
    and returns the raw output dict ``fastsim._assemble`` consumes.
    ``elapsed`` accumulates native drive-loop seconds only.
    """

    def __init__(
        self,
        lib: ctypes.CDLL,
        params,
        n_objects: int,
        lengths: np.ndarray,
        warmup: int,
        ripple_from: int,
        scale: int,
    ) -> None:
        self.lib = lib
        J = len(params.allocations)
        N = int(n_objects)
        self.J, self.N = J, N
        b = [int(x) for x in params.allocations]
        b_hat = (
            [int(x) for x in params.ripple_allocations]
            if params.ripple_allocations is not None
            else list(b)
        )
        B = (
            params.physical_capacity
            if params.physical_capacity is not None
            else sum(b)
        )
        self.scale = int(scale)
        self.B = int(B)
        self.ghost = int(bool(params.ghost_retention))
        self.warmup = int(warmup)
        self.ripple_from = int(ripple_from)
        self.batch_interval = int(params.batch_interval)

        self.lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        self.b_a = np.asarray([x * scale for x in b], dtype=np.int64)
        self.bhat_a = np.asarray([x * scale for x in b_hat], dtype=np.int64)
        self.share = np.asarray(
            [0] + [scale // p for p in range(1, J + 1)] + [0], dtype=np.int64
        )

        self.head = np.full(J, -1, dtype=np.int64)
        self.tail = np.full(J, -1, dtype=np.int64)
        self.hmask = np.zeros(N, dtype=np.uint64)
        self.length = np.zeros(N, dtype=np.int64)
        self.vlen = np.zeros(J, dtype=np.int64)
        self.gnxt = np.full(N, -1, dtype=np.int64)
        self.gprv = np.full(N, -1, dtype=np.int64)
        self.isghost = np.zeros(N, dtype=np.uint8)
        self.slot = np.full(N, -1, dtype=np.int64)
        self.cap = min(N, INITIAL_SLOT_CAP)
        self.slot_key = np.zeros(self.cap, dtype=np.int64)
        self.nxt = np.full(self.cap * J, -1, dtype=np.int64)
        self.prv = np.full(self.cap * J, -1, dtype=np.int64)
        self.res_since = np.full(self.cap * J, -1, dtype=np.int64)
        self.tot_time = np.zeros(self.cap * J, dtype=np.int64)
        self.sc = np.zeros(SC_COUNT, dtype=np.int64)
        self.sc[SC_GHEAD] = self.sc[SC_GTAIL] = -1
        self.hits_p = np.zeros(J, dtype=np.int64)
        self.reqs_p = np.zeros(J, dtype=np.int64)
        self.hist = np.zeros(HIST_LEN, dtype=np.int64)
        self.idx = 0
        self.elapsed = 0.0

    def _grow(self) -> None:
        J = self.J
        new_cap = min(self.N, max(self.cap * 2, 1))
        if new_cap == self.cap:  # pragma: no cover - slots are <= N
            raise RuntimeError("touched-set capacity exhausted at N slots")

        def grown(a: np.ndarray, per: int, fill) -> np.ndarray:
            b = np.full(new_cap * per, fill, dtype=a.dtype)
            b[: self.cap * per] = a
            return b

        self.slot_key = grown(self.slot_key, 1, 0)
        self.nxt = grown(self.nxt, J, -1)
        self.prv = grown(self.prv, J, -1)
        self.res_since = grown(self.res_since, J, -1)
        self.tot_time = grown(self.tot_time, J, 0)
        self.cap = new_cap

    def feed(self, proxies: np.ndarray, objects: np.ndarray) -> None:
        P = np.ascontiguousarray(proxies, dtype=np.int32)
        O = np.ascontiguousarray(objects, dtype=np.int64)
        _check_ids(P, O, self.J, self.N)
        n = len(P)
        off = 0
        while off < n:
            Pv, Ov = P[off:], O[off:]
            t0 = time.perf_counter()
            consumed = self.lib.drive_chunk(
                self.idx, n - off,
                self.J, self.N,
                _ptr(Pv, _I32P), _ptr(Ov, _I64P),
                _ptr(self.lengths, _I64P), _ptr(self.b_a, _I64P),
                _ptr(self.bhat_a, _I64P), _ptr(self.share, _I64P),
                self.scale, self.B, self.ghost,
                self.warmup, self.ripple_from, self.batch_interval,
                _ptr(self.head, _I64P), _ptr(self.tail, _I64P),
                _ptr(self.hmask, _U64P), _ptr(self.length, _I64P),
                _ptr(self.vlen, _I64P),
                _ptr(self.gnxt, _I64P), _ptr(self.gprv, _I64P),
                _ptr(self.isghost, _U8P),
                _ptr(self.slot, _I64P), _ptr(self.slot_key, _I64P), self.cap,
                _ptr(self.nxt, _I64P), _ptr(self.prv, _I64P),
                _ptr(self.res_since, _I64P), _ptr(self.tot_time, _I64P),
                _ptr(self.sc, _I64P), _ptr(self.hits_p, _I64P),
                _ptr(self.reqs_p, _I64P),
                _ptr(self.hist, _I64P), HIST_LEN,
            )
            self.elapsed += time.perf_counter() - t0
            if consumed < 0:  # pragma: no cover - no failure paths today
                raise RuntimeError(f"drive_chunk failed with rc={consumed}")
            self.idx += consumed
            off += consumed
            if off < n:  # touched-set capacity exhausted mid-chunk
                self._grow()

    def counters(self) -> dict:
        """Cumulative hit/miss/ripple counters, readable between ``feed``
        calls (whole-stream totals; the per-proxy arrays are post-warmup
        and the ripple fields post-``ripple_from``)."""
        return {
            "n_hit_list": int(self.sc[SC_NHITLIST]),
            "n_hit_cache": int(self.sc[SC_NHITCACHE]),
            "n_miss": int(self.sc[SC_NMISS]),
            "hits_by_proxy": self.hits_p.copy(),
            "reqs_by_proxy": self.reqs_p.copy(),
            "hist": self.hist.copy(),
            "n_sets": int(self.sc[SC_NSETS]),
            "n_prim": int(self.sc[SC_NPRIM]),
            "n_rip": int(self.sc[SC_NRIP]),
            "n_batch": int(self.sc[SC_NBATCH]),
        }

    def finish(self, n_total: int) -> Dict[str, np.ndarray]:
        n_slots = int(self.sc[SC_NSLOTS])
        t_start = int(self.sc[SC_TSTART])
        rs = self.res_since[: n_slots * self.J]
        tt = self.tot_time[: n_slots * self.J]
        open_m = rs >= 0
        tt[open_m] += n_total - np.maximum(rs[open_m], t_start)
        rs[open_m] = n_total
        return {
            "tot_time_slots": tt,
            "slot_keys": self.slot_key[:n_slots],
            "horizon": max(n_total - t_start, 1),
            "vlen": self.vlen,
            "n_hit_list": int(self.sc[SC_NHITLIST]),
            "n_hit_cache": int(self.sc[SC_NHITCACHE]),
            "n_miss": int(self.sc[SC_NMISS]),
            "hits_p": self.hits_p,
            "reqs_p": self.reqs_p,
            "hist": self.hist,
            "n_sets": int(self.sc[SC_NSETS]),
            "n_prim": int(self.sc[SC_NPRIM]),
            "n_rip": int(self.sc[SC_NRIP]),
            "n_batch": int(self.sc[SC_NBATCH]),
        }


class NoshareChunkRunner:
    """Incremental native driver for the not-shared (Table-III) baseline."""

    def __init__(
        self,
        lib: ctypes.CDLL,
        allocations,
        n_objects: int,
        lengths: np.ndarray,
        warmup: int,
    ) -> None:
        self.lib = lib
        J = len(allocations)
        N = int(n_objects)
        self.J, self.N = J, N
        self.warmup = int(warmup)
        self.lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        self.b_a = np.asarray([int(x) for x in allocations], dtype=np.int64)
        self.nxt = np.full(J * N, -1, dtype=np.int64)
        self.prv = np.full(J * N, -1, dtype=np.int64)
        self.head = np.full(J, -1, dtype=np.int64)
        self.tail = np.full(J, -1, dtype=np.int64)
        self.inlist = np.zeros(J * N, dtype=np.uint8)
        self.used = np.zeros(J, dtype=np.int64)
        self.res_since = np.full(J * N, -1, dtype=np.int64)
        self.tot_time = np.zeros(J * N, dtype=np.int64)
        self.sc = np.zeros(3, dtype=np.int64)
        self.hits_p = np.zeros(J, dtype=np.int64)
        self.reqs_p = np.zeros(J, dtype=np.int64)
        self.idx = 0
        self.elapsed = 0.0

    def feed(self, proxies: np.ndarray, objects: np.ndarray) -> None:
        P = np.ascontiguousarray(proxies, dtype=np.int32)
        O = np.ascontiguousarray(objects, dtype=np.int64)
        _check_ids(P, O, self.J, self.N)
        n = len(P)
        t0 = time.perf_counter()
        rc = self.lib.noshare_chunk(
            self.idx, n,
            self.J, self.N,
            _ptr(P, _I32P), _ptr(O, _I64P),
            _ptr(self.lengths, _I64P), _ptr(self.b_a, _I64P),
            self.warmup,
            _ptr(self.nxt, _I64P), _ptr(self.prv, _I64P),
            _ptr(self.head, _I64P), _ptr(self.tail, _I64P),
            _ptr(self.inlist, _U8P), _ptr(self.used, _I64P),
            _ptr(self.res_since, _I64P), _ptr(self.tot_time, _I64P),
            _ptr(self.sc, _I64P), _ptr(self.hits_p, _I64P),
            _ptr(self.reqs_p, _I64P),
        )
        self.elapsed += time.perf_counter() - t0
        if rc < 0:  # pragma: no cover
            raise RuntimeError(f"noshare_chunk failed with rc={rc}")
        self.idx += n

    def finish(self, n_total: int) -> Dict[str, np.ndarray]:
        t_start = int(self.sc[0])
        open_m = self.res_since >= 0
        self.tot_time[open_m] += n_total - np.maximum(
            self.res_since[open_m], t_start
        )
        self.res_since[open_m] = n_total
        return {
            "tot_time": self.tot_time,
            "horizon": max(n_total - t_start, 1),
            "vlen": self.used,
            "n_hit_list": int(self.sc[1]),
            "n_hit_cache": 0,
            "n_miss": int(self.sc[2]),
            "hits_p": self.hits_p,
            "reqs_p": self.reqs_p,
            "hist": np.zeros(1, dtype=np.int64),
            "n_sets": 0,
            "n_prim": 0,
            "n_rip": 0,
            "n_batch": 0,
        }


def make_flat_runner(
    params, n_objects: int, lengths, warmup: int, ripple_from: int, scale: int
) -> Optional[FlatChunkRunner]:
    """A native flat-LRU chunk runner, or None when no C backend exists."""
    lib = _load()
    if lib is None:
        return None
    return FlatChunkRunner(
        lib, params, n_objects, lengths, warmup, ripple_from, scale
    )


def make_noshare_runner(
    allocations, n_objects: int, lengths, warmup: int
) -> Optional[NoshareChunkRunner]:
    lib = _load()
    if lib is None:
        return None
    return NoshareChunkRunner(lib, allocations, n_objects, lengths, warmup)
