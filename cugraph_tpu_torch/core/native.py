"""ctypes loader for the host engines in ``_native/builder.cpp``.

Counterpart of ``cugraph_tpu.core.native`` for the functions the port
calls: the R-MAT generator, the hash renumber, the duplicate-edge dedupe,
the exact core peel, the Louvain sweep, the Leiden refinement sweep
and the cluster contraction of community detection, and the
degree-oriented wedge engine of triangle counting and k-truss.  The library is
built with g++ at first use into ``build/native/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
and published with an atomic rename, so that concurrent builders never
interleave and a stale build is never loaded.  Nothing is built at
import.

Unlike the JAX package, which falls back to NumPy (or, for the
community sweeps, to XLA) when no compiler is present or an engine fails,
a missing g++ or a failed build raises with the compiler's output, and a
nonzero return of an engine raises with its code: a run on the card
never times a fallback by accident.  The
NumPy versions stay in their modules as the plain versions the tests hold
these engines against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                   "builder.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "native")
CXX = "g++"
# no -march=native: the library is built on every machine anyway, and
# baseline x86-64 code keeps the floating point of rmat_edgelist the same
# on all of them
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path() -> str:
    """The library's path, named by a hash of the compiler, the flags and
    the source."""
    digest = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"builder_{digest.hexdigest()[:16]}.so")


def start_build():
    """Start g++ on the source; None when the library is already built.
    ``finish_build`` waits for it, so that a caller can build beside other
    work."""
    so = library_path()
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # per process: builders never share
    cmd = [CXX, *CXX_FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX} to build {SRC}: {e}") from e
    return so, tmp, cmd, proc


def finish_build(job) -> None:
    if job is None:
        return
    so, tmp, cmd, proc = job
    out, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
    os.replace(tmp, so)  # atomic publish


def get_lib() -> ctypes.CDLL:
    """The loaded library, built if needed; raises if it cannot be."""
    so = library_path()
    lib = _libs.get(so)
    if lib is not None:
        return lib
    with _lock:
        if so not in _libs:
            finish_build(start_build())
            _libs[so] = _bind(ctypes.CDLL(so))
        return _libs[so]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.renumber_edgelist64.restype = ctypes.c_int64
    lib.renumber_edgelist64.argtypes = [i64p, i64p, ctypes.c_int64, i64p,
                                        i32p, i32p]
    lib.rmat_edgelist.restype = None
    lib.rmat_edgelist.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_uint64,
                                  ctypes.c_int, ctypes.c_int, i32p, i32p]
    lib.core_number_peel.restype = ctypes.c_int
    lib.core_number_peel.argtypes = [i64p, i32p, ctypes.c_int64, i64p, i32p]
    lib.dedupe_edges.restype = ctypes.c_int64
    lib.dedupe_edges.argtypes = [i32p, i32p, f32p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, i64p, f32p]
    lib.louvain_sweep.restype = ctypes.c_int
    lib.louvain_sweep.argtypes = [i32p, f32p, ctypes.c_int64, ctypes.c_int64,
                                  i64p, i32p, i32p, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_int, i32p]
    lib.leiden_refine_sweep.restype = ctypes.c_int
    lib.leiden_refine_sweep.argtypes = [i32p, f32p, ctypes.c_int64,
                                        ctypes.c_int64, i64p, i32p, i32p,
                                        ctypes.c_double, ctypes.c_double,
                                        ctypes.c_uint64, ctypes.c_int, i32p]
    lib.coarsen_edges.restype = ctypes.c_int64
    lib.coarsen_edges.argtypes = [i32p, i32p, f32p, ctypes.c_int64,
                                  ctypes.c_int64, i32p, i32p, f32p]
    lib.triangle_support.restype = ctypes.c_int
    lib.triangle_support.argtypes = [i64p, i64p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, i64p, i64p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def renumber_native(src, dst):
    """Hash renumber: (src, dst) as int64 -> (unique ids in first-seen
    order, src int32, dst int32)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    m = src.shape[0]
    uniq = np.empty(max(2 * m, 1), np.int64)
    so = np.empty(m, np.int32)
    do = np.empty(m, np.int32)
    n = lib.renumber_edgelist64(_ptr(src, ctypes.c_int64),
                                _ptr(dst, ctypes.c_int64), m,
                                _ptr(uniq, ctypes.c_int64),
                                _ptr(so, ctypes.c_int32),
                                _ptr(do, ctypes.c_int32))
    return uniq[:n].copy(), so, do


def rmat_native(scale, num_edges, a, b, c, seed, clip_and_flip):
    """Threaded R-MAT: (src, dst) int32, bit-identical to the NumPy
    counter RNG of ``generators/rmat._rmat_numpy``."""
    lib = get_lib()
    src = np.empty(num_edges, np.int32)
    dst = np.empty(num_edges, np.int32)
    lib.rmat_edgelist(int(scale), int(num_edges), float(a), float(b),
                      float(c), ctypes.c_uint64(int(seed) & (2**64 - 1)),
                      int(bool(clip_and_flip)), _threads(),
                      _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32))
    return src, dst


def core_number_peel_native(row_off, adj, deg_init):
    """Exact Batagelj-Zaversnik peel: core int32[n] of the degrees
    ``deg_init``, where removing v decrements the entries of its row of
    (row_off, adj)."""
    lib = get_lib()
    row_off = np.ascontiguousarray(row_off, np.int64)
    adj = np.ascontiguousarray(adj, np.int32)
    deg_init = np.ascontiguousarray(deg_init, np.int64)
    n = len(row_off) - 1
    out = np.empty(n, np.int32)
    rc = lib.core_number_peel(
        _ptr(row_off, ctypes.c_int64), _ptr(adj, ctypes.c_int32), n,
        _ptr(deg_init, ctypes.c_int64), _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"core_number_peel returned {rc}")
    return out


def dedupe_edges_native(src, dst, w, n, mode):
    """Duplicate-pair coalescing over dense ids in [0, n).  ``mode``: 0
    keeps the first edge of each pair, 1/2/3 reduce the weights by sum,
    min or max.  Returns (the kept edges' input positions, int64, in (src,
    dst) key order; the reduced weights float32, or None for mode 0)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    m = len(src)
    keep = np.empty(m, np.int64)
    wout = np.empty(m if mode else 0, np.float32)
    wptr = (np.ascontiguousarray(w, np.float32) if w is not None
            else np.empty(0, np.float32))
    cnt = lib.dedupe_edges(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(wptr, ctypes.c_float) if w is not None else None,
        m, int(n), int(mode), _ptr(keep, ctypes.c_int64),
        _ptr(wout, ctypes.c_float))
    if cnt < 0:
        raise RuntimeError(f"dedupe_edges returned {cnt}")
    return keep[:cnt].copy(), (wout[:cnt].copy() if mode else None)


def louvain_sweep_native(dst_sorted, w_sorted, row_off, cluster, up_down,
                         resolution, rank=None):
    """One parallel Louvain local-moving sweep over a graph sorted by
    source (``row_off`` [n+1] int64 offsets into ``dst_sorted`` and
    ``w_sorted``), every move judged against the snapshot ``cluster``;
    ``up_down`` allows moves to higher (True) or lower cluster ids only.
    ``rank`` optionally relabels the id order of the direction filter and
    the tie-break (ECG's ensemble permutation without re-sorting the
    graph).  Returns the new cluster array, int32 [n]."""
    lib = get_lib()
    dst_sorted = np.ascontiguousarray(dst_sorted, np.int32)
    w_sorted = np.ascontiguousarray(w_sorted, np.float32)
    row_off = np.ascontiguousarray(row_off, np.int64)
    cluster = np.ascontiguousarray(cluster, np.int32)
    rank = None if rank is None else np.ascontiguousarray(rank, np.int32)
    n = len(row_off) - 1
    out = np.empty(n, np.int32)
    rc = lib.louvain_sweep(
        _ptr(dst_sorted, ctypes.c_int32), _ptr(w_sorted, ctypes.c_float),
        len(dst_sorted), n, _ptr(row_off, ctypes.c_int64),
        _ptr(cluster, ctypes.c_int32),
        None if rank is None else _ptr(rank, ctypes.c_int32),
        int(bool(up_down)), float(resolution), _threads(),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"louvain_sweep returned {rc}")
    return out


def leiden_refine_sweep_native(dst_sorted, w_sorted, row_off, comm, refined,
                               theta, resolution, seed):
    """One randomized Leiden refinement sweep: singleton sub-communities
    merge into smaller-id ones within their community ``comm``, targets
    drawn in proportion to exp(gain / theta) by Gumbel-max from a counter
    RNG keyed by ``seed`` (64 bits), behind the well-connectedness gates.
    Returns the path-compressed refined labels, int32 [n]."""
    lib = get_lib()
    dst_sorted = np.ascontiguousarray(dst_sorted, np.int32)
    w_sorted = np.ascontiguousarray(w_sorted, np.float32)
    row_off = np.ascontiguousarray(row_off, np.int64)
    comm = np.ascontiguousarray(comm, np.int32)
    refined = np.ascontiguousarray(refined, np.int32)
    n = len(row_off) - 1
    out = np.empty(n, np.int32)
    rc = lib.leiden_refine_sweep(
        _ptr(dst_sorted, ctypes.c_int32), _ptr(w_sorted, ctypes.c_float),
        len(dst_sorted), n, _ptr(row_off, ctypes.c_int64),
        _ptr(comm, ctypes.c_int32), _ptr(refined, ctypes.c_int32),
        float(theta), float(resolution),
        ctypes.c_uint64(int(seed) & (2**64 - 1)), _threads(),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"leiden_refine_sweep returned {rc}")
    return out


def coarsen_edges_native(cs, cd, w, nc):
    """Aggregate parallel edges of a graph relabelled to cluster ids in
    [0, nc): (src, dst, summed float32 weight), sorted by (src, dst)."""
    lib = get_lib()
    cs = np.ascontiguousarray(cs, np.int32)
    cd = np.ascontiguousarray(cd, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    m = len(cs)
    osrc = np.empty(m, np.int32)
    odst = np.empty(m, np.int32)
    ow = np.empty(m, np.float32)
    cnt = lib.coarsen_edges(
        _ptr(cs, ctypes.c_int32), _ptr(cd, ctypes.c_int32),
        _ptr(w, ctypes.c_float), m, int(nc),
        _ptr(osrc, ctypes.c_int32), _ptr(odst, ctypes.c_int32),
        _ptr(ow, ctypes.c_float))
    if cnt < 0:
        raise RuntimeError(f"coarsen_edges returned {cnt}")
    return osrc[:cnt].copy(), odst[:cnt].copy(), ow[:cnt].copy()


def triangle_support_native(u, v, n, need_support):
    """Degree-oriented wedge triangle count over UNIQUE undirected edges
    (u[i], v[i]) without self-loops, any order within a pair: (tri int64
    [n] per vertex, sup int64 [M] per input edge or None).  Each thread
    keeps (n + M)·8 B of accumulators, so the threads are capped to keep
    them under ~2 GB in all, as the JAX package's wrapper does."""
    lib = get_lib()
    u = np.ascontiguousarray(u, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    per = (int(n) + len(u)) * 8
    n_threads = max(1, min(_threads(), (2 << 30) // max(per, 1)))
    tri = np.empty(int(n), np.int64)
    sup = np.empty(len(u) if need_support else 0, np.int64)
    rc = lib.triangle_support(
        _ptr(u, ctypes.c_int64), _ptr(v, ctypes.c_int64), len(u), int(n),
        int(bool(need_support)), n_threads, _ptr(tri, ctypes.c_int64),
        _ptr(sup, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"triangle_support returned {rc}")
    return tri, (sup if need_support else None)
