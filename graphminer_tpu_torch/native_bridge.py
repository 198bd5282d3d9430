"""ctypes bridge to the native C++ preprocessing library (native/graphcore.cpp).

The counterpart of graphminer_tpu/native_bridge.py with one difference: it
never loads the committed native/libgraphcore.so. That file is built with
-march=native on whichever host last ran `make`, and on a host with another
instruction set it dies with SIGILL, which no `except OSError` catches.
This bridge compiles its own copy from native/graphcore.cpp at first use,
without -march=native, into the port's git-ignored build directory, keyed by
a hash of the source, and loads that copy. native/ itself is not touched.
It binds orient, relabel_by_degree, sort_neighbors, edge_list, csr_from_coo,
expand_emit (the k-clique engines' task enumerator), expand_multi (its
(task, bit) form), count_multi (the k >= 6 engine's per-task popcount
prepass), kclique_dfs (an independent DFS k-clique counter that the
tests and the smoke script hold the bitmap engines against) and c4_anchor
(the rectangle engine's max-anchored wedge pass, which closes its
recursion) and t3ss (the house engine's sub-sub-mid share of the per-edge
3-walk support).

Every entry point returns None when the library is unavailable (no g++ or
a failed build); core/graph.py then takes its numpy path. Which path was
taken is logged.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "graphcore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CXXFLAGS = ["-O3", "-fopenmp", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgraphcore_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile graphcore.cpp into `path`; raises on failure. A file lock
    serializes concurrent builds (test workers, a CLI subprocess)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)


def get_lib():
    """The loaded library or None (numpy fallback)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native preprocessing unavailable (%s); numpy path", e)
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.gm_orient.restype = ctypes.c_int64
        lib.gm_orient.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p,
                                  i64p, i32p]
        lib.gm_relabel_by_degree.restype = None
        lib.gm_relabel_by_degree.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i32p, ctypes.c_int,
            i64p, i32p, i32p, i32p]
        lib.gm_sort_neighbors.restype = None
        lib.gm_sort_neighbors.argtypes = [ctypes.c_int64, i64p, i32p]
        lib.gm_edge_list.restype = ctypes.c_int64
        lib.gm_edge_list.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                     i32p, ctypes.c_int, ctypes.c_int,
                                     i32p, i32p]
        lib.gm_num_threads.restype = ctypes.c_int
        lib.gm_num_threads.argtypes = []
        lib.gm_csr_from_coo.restype = ctypes.c_int64
        lib.gm_csr_from_coo.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, ctypes.c_int,
            i64p, i32p]
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.gm_expand_emit.restype = ctypes.c_int64
        lib.gm_expand_emit.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, pp, pp, ctypes.c_int64, pp, ctypes.c_int64, i32p,
            i64p]
        lib.gm_expand_multi.restype = ctypes.c_int64
        lib.gm_expand_multi.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, pp, pp, ctypes.c_int64, i64p, i32p, i64p]
        lib.gm_count_multi.restype = None
        lib.gm_count_multi.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            pp, pp, i32p]
        lib.gm_kclique.restype = ctypes.c_int64
        lib.gm_kclique.argtypes = [ctypes.c_int64, i64p, i32p, ctypes.c_int64]
        lib.gm_c4.restype = ctypes.c_int64
        lib.gm_c4.argtypes = [ctypes.c_int64, i64p, i32p]
        lib.gm_t3ss.restype = None
        lib.gm_t3ss.argtypes = [ctypes.c_int64, i64p, i32p, ctypes.c_int64,
                                i32p]
        log.info("native preprocessing: %s (%d threads)", path,
                 lib.gm_num_threads())
        _lib = lib
        return _lib


def orient(rowptr: np.ndarray, colidx: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    out_rowptr = np.zeros(v + 1, dtype=np.int64)
    out_colidx = np.zeros(e // 2 + 1, dtype=np.int32)
    kept = lib.gm_orient(v, e, np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32),
                         out_rowptr, out_colidx)
    return out_rowptr, out_colidx[:kept].copy()


def relabel_by_degree(rowptr: np.ndarray, colidx: np.ndarray,
                      descending: bool):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    out_rowptr = np.zeros(v + 1, dtype=np.int64)
    out_colidx = np.zeros(e, dtype=np.int32)
    perm = np.zeros(v, dtype=np.int32)
    inv = np.zeros(v, dtype=np.int32)
    lib.gm_relabel_by_degree(v, e, np.ascontiguousarray(rowptr, np.int64),
                             np.ascontiguousarray(colidx, np.int32),
                             int(descending), out_rowptr, out_colidx,
                             perm, inv)
    return out_rowptr, out_colidx, perm, inv


def edge_list(rowptr: np.ndarray, colidx: np.ndarray, sym_break: bool,
              ascend: bool):
    lib = get_lib()
    if lib is None:
        return None
    v = rowptr.shape[0] - 1
    e = colidx.shape[0]
    src = np.zeros(e, dtype=np.int32)
    dst = np.zeros(e, dtype=np.int32)
    n = lib.gm_edge_list(v, e, np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32),
                         int(sym_break), int(ascend), src, dst)
    return src[:n].copy(), dst[:n].copy()


def csr_from_coo(src: np.ndarray, dst: np.ndarray, n_vertices: int,
                 symmetrize: bool):
    """(rowptr, colidx) sorted+dedup'd CSR from COO, or None (numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    e = src.shape[0]
    cap = 2 * e if symmetrize else e
    rowptr = np.zeros(n_vertices + 1, dtype=np.int64)
    colidx = np.empty(max(cap, 1), dtype=np.int32)
    n = lib.gm_csr_from_coo(n_vertices, e, src, dst, int(symmetrize),
                            rowptr, colidx)
    return rowptr, colidx[:n].copy()


def _pointers(arrays):
    """A C array of the arrays' data pointers (void **)."""
    return ctypes.cast(
        (ctypes.c_void_p * len(arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays]),
        ctypes.POINTER(ctypes.c_void_p))


def expand_emit(bases, rows, attrs, words: int, n_bits: int, start: int,
                cap: int, out: np.ndarray):
    """State-carrying expansion (gm_expand_emit): for tasks from `start`,
    AND the bitmap rows bases[s][rows[s][t]]; for every set bit below n_bits
    write [attrs[0][t], ..., attrs[-1][t], bit] into `out` ([cap, n_attr+1]
    int32), task-major and bit-ascending, whole tasks only. Returns
    (n_emitted, next_start), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    attrs_c = [np.ascontiguousarray(a, dtype=np.int32) for a in attrs]
    if not out.flags["C_CONTIGUOUS"] or out.dtype != np.int32 or \
            out.shape[1] != len(attrs) + 1:
        raise ValueError(f"out must be C-contiguous int32 [cap, "
                         f"{len(attrs) + 1}], got {out.dtype} {out.shape}")
    nxt = np.zeros(1, dtype=np.int64)
    n = lib.gm_expand_emit(
        rows_c[0].shape[0], start, words, n_bits, len(bases_c),
        _pointers(bases_c), _pointers(rows_c), len(attrs_c),
        _pointers(attrs_c), cap, out.reshape(-1), nxt)
    return int(n), int(nxt[0])


def expand_multi(bases, rows, words: int, n_bits: int, start: int,
                 cap: int, out_task: np.ndarray, out_bit: np.ndarray):
    """Streamed set-bit expansion (gm_expand_multi): for tasks from
    `start`, AND the bitmap rows bases[s][rows[s][t]] (rows int64) and
    write (task, bit) for every set bit below n_bits into out_task (int64)
    and out_bit (int32), capacity cap, task-major and bit-ascending, whole
    tasks only. Returns (n_emitted, next_start), or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int64) for r in rows]
    for name, a, dt in (("out_task", out_task, np.int64),
                        ("out_bit", out_bit, np.int32)):
        if not a.flags["C_CONTIGUOUS"] or a.dtype != dt or a.shape[0] < cap:
            raise ValueError(f"{name} must be C-contiguous {dt.__name__} "
                             f"[>= {cap}], got {a.dtype} {a.shape}")
    nxt = np.zeros(1, dtype=np.int64)
    n = lib.gm_expand_multi(
        rows_c[0].shape[0], start, words, n_bits, len(bases_c),
        _pointers(bases_c), _pointers(rows_c), cap, out_task, out_bit, nxt)
    return int(n), int(nxt[0])


def count_multi(bases, rows, words: int, n_bits: int):
    """Per-task popcount below n_bits of the AND of the bitmap rows
    bases[s][rows[s][t]] (gm_count_multi), int32 [n], or None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bases_c = [np.ascontiguousarray(b.view(np.uint32)) for b in bases]
    rows_c = [np.ascontiguousarray(r, dtype=np.int32) for r in rows]
    out = np.empty(rows_c[0].shape[0], dtype=np.int32)
    lib.gm_count_multi(rows_c[0].shape[0], words, n_bits, len(bases_c),
                       _pointers(bases_c), _pointers(rows_c), out)
    return out


def kclique_dfs(rowptr: np.ndarray, colidx: np.ndarray, k: int):
    """k-clique count by a DAG depth-first search with sorted-merge
    intersections (gm_kclique), which shares no code with the bitmap
    engines; the input is the oriented DAG with sorted rows. None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.gm_kclique(rowptr.shape[0] - 1,
                              np.ascontiguousarray(rowptr, np.int64),
                              np.ascontiguousarray(colidx, np.int32), k))


def c4_anchor(rowptr: np.ndarray, colidx: np.ndarray):
    """Max-anchored 4-cycle count by the wedge pass (gm_c4): each 4-cycle
    once, at the diagonal that holds its largest id. The rows must be
    sorted ascending. None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.gm_c4(rowptr.shape[0] - 1,
                         np.ascontiguousarray(rowptr, np.int64),
                         np.ascontiguousarray(colidx, np.int32)))


def t3ss(rowptr: np.ndarray, colidx: np.ndarray, cs: int):
    """The sub-sub-mid share of the 3-walk support (gm_t3ss): for every
    DAG edge (u, v), v > u, the pairs (x in N(u), y in N(v)) with x ~ y and
    x, y < cs, int32 [nnz] at the edge's CSR position (col > row; the other
    entries are 0). The rows must be sorted ascending. None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(colidx.shape[0], dtype=np.int32)
    lib.gm_t3ss(rowptr.shape[0] - 1, np.ascontiguousarray(rowptr, np.int64),
                np.ascontiguousarray(colidx, np.int32), cs, out)
    return out
