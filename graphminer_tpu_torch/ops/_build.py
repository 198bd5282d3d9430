"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain C
interface, which is loaded with ctypes (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c csrc/<name>.cu -o _build/<name>.<pid>.o   (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libgm_kernels_<hash>.so _build/*.<pid>.o

The library lands in the package's git-ignored _build/ directory under a
name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is built once per checkout. A file lock
serializes concurrent builds (several processes of one run).

Each C entry point takes every pointer as c_void_p (tensor.data_ptr()),
sizes as c_int64 and the stream as c_void_p (stream(device), the raw handle
of the device's current stream), launches on that stream without
synchronizing, and returns cudaGetLastError(). The *_blocks entry points
return the blocks of one full wave of a persistent kernel's grid (SMs x
resident blocks), or a negative CUDA error.

A wrapper's host path is part of every timing of a small kernel, so it is
kept short: once the library is loaded, kernels() returns it without the
lock, entry() hands out each entry point's ctypes function from a dict, and
stream() reads the raw stream handle without building a torch Stream.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build in this process reported: seconds and nvcc's output
#: (ptxas register/shared-memory lines); None when the library was cached
BUILD_INFO = None

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # bucket records, tile records, n_tiles, partials, n_blocks, stream
    "gm_stream_count": [_VP, _VP, _I64, _VP, _I64, _VP],
    # -> blocks of one full wave (negative: a CUDA error)
    "gm_stream_count_blocks": [],
    # bucket records, tiles, block ranges, items, stage_rows, partials,
    # n_blocks, stream
    "gm_ring_phase_c": [_VP, _VP, _VP, _VP, _I64, _VP, _I64, _VP],
    # stage_rows -> blocks of one full wave (negative: a CUDA error)
    "gm_ring_phase_c_blocks": [_I64],
    # bucket records, tile records, n_tiles, region, partials, n_blocks,
    # stream
    "gm_ring_tail_pairs": [_VP, _VP, _I64, _I64, _VP, _I64, _VP],
    # region -> blocks of one full wave (negative: a CUDA error)
    "gm_ring_tail_pairs_blocks": [_I64],
    # src_rows, ns, dst_rows, nd, row_w, words, group records, tiles,
    # n_tiles, partials, n_blocks, stream
    "gm_hub_tail_count": [_VP, _I64, _VP, _I64, _I64, _I64, _VP, _VP, _I64,
                          _VP, _I64, _VP],
    # -> blocks of one full wave (negative: a CUDA error)
    "gm_hub_tail_count_blocks": [],
    # idx, t, table, v, w, n_buf, workspace, out, n_blocks, stream
    "gm_fetch_rows_sum": [_VP, _I64, _VP, _I64, _I64, _I64, _VP, _VP, _I64,
                          _VP],
    # vec (4: 16-byte lanes, 1: 4-byte), n_buf -> blocks of one full wave
    # (negative: a CUDA error)
    "gm_fetch_rows_sum_blocks": [_I64, _I64],
    # src, table, nd, starts, lidx, nck, cap, w, span, rows_per_step,
    # workspace, out, n_blocks, stream
    "gm_window_count": [_VP, _VP, _I64, _VP, _VP, _I64, _I64, _I64, _I64,
                        _I64, _VP, _VP, _I64, _VP],
    # rows_per_step -> blocks of one full wave (negative: a CUDA error)
    "gm_window_count_blocks": [_I64],
    # x, o, n, n_blocks, stream
    "gm_times_two": [_VP, _VP, _I64, _I64, _VP],
    # base, ldb, nb, r, tab, ldt, nt, c, depth, n, hw, n_out, transpose,
    # out, stream
    "gm_expand_bits": [_VP, _I64, _I64, _VP, _VP, _I64, _I64, _VP, _I64,
                       _I64, _I64, _I64, _I64, _VP, _VP],
    # bm, v, core, c, words, shared, ns, vc, starts, vary, n_runs,
    # partials, n_blocks, stream
    "gm_lo_popcount": [_VP, _I64, _VP, _I64, _I64, _VP, _I64, _I64, _VP,
                       _VP, _I64, _VP, _I64, _VP],
    # ns -> blocks of one full wave (negative: a CUDA error)
    "gm_lo_popcount_blocks": [_I64],
    # base, ldb, nb, r, tab, ldt, nt, c, depth, n, hw, mask, ldm, nm, tiles,
    # n_tiles, kc, n_items, out, n_blocks, stream
    "gm_bit_gram": [_VP, _I64, _I64, _VP, _VP, _I64, _I64, _VP, _I64, _I64,
                    _I64, _VP, _I64, _I64, _VP, _I64, _I64, _I64, _VP, _I64,
                    _VP],
    # depth -> blocks of one full wave (negative: a CUDA error)
    "gm_bit_gram_blocks": [_I64],
    # y2, ldy, ny, core, ldc, nc, nw, n_bits, erow, c1, n, counts,
    # n_blocks, stream
    "gm_quad_count": [_VP, _I64, _I64, _VP, _I64, _I64, _I64, _I64, _VP,
                      _VP, _I64, _VP, _I64, _VP],
    # y2, ldy, ny, core, ldc, nc, nw, n_bits, erow, c1, off, n, r_out,
    # cols_out, n_blocks, stream
    "gm_quad_emit": [_VP, _I64, _I64, _VP, _I64, _I64, _I64, _I64, _VP, _VP,
                     _VP, _I64, _VP, _VP, _I64, _VP],
    # tab, v, words, src, dst, n, out, n_blocks, stream
    "gm_tri_bitmap": [_VP, _I64, _I64, _VP, _VP, _I64, _VP, _I64, _VP],
    # rowptr, colidx, ftw, tab, v, words, u, vloc, n, out, n_blocks, stream
    "gm_tri_probe": [_VP, _VP, _VP, _VP, _I64, _I64, _VP, _VP, _I64, _VP,
                     _I64, _VP],
    # rowptr, colidx, ftw, v, u, w, n, out, n_blocks, stream
    "gm_tri_lists": [_VP, _VP, _VP, _I64, _VP, _VP, _I64, _VP, _I64, _VP],
    # rowptr, colidx, ftw, tab, v, words, u, n, out, n_blocks, threads,
    # stream
    "gm_bit_colsum": [_VP, _VP, _VP, _VP, _I64, _I64, _VP, _I64, _VP, _I64,
                      _I64, _VP],
    # rowptr, colidx, tab, v, words, cs, c, items, n, lg, counts, total,
    # n_blocks, stream
    "gm_colsum_pairs": [_VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP, _I64,
                        _I64, _VP, _VP, _I64, _VP],
    # -> blocks of one full wave (negative: a CUDA error)
    "gm_colsum_pairs_blocks": [],
    # counts, long_u, n_long, words, cs, c, total, n_blocks, stream
    "gm_colsum_finish": [_VP, _VP, _I64, _I64, _I64, _I64, _VP, _I64, _VP],
    # rowptr, colidx, tab, v, words, a, b, items, n_block, m, nbc, cs, out,
    # n_blocks, stream
    "gm_house_t3": [_VP, _VP, _VP, _I64, _I64, _VP, _VP, _VP, _I64, _I64,
                    _VP, _I64, _VP, _I64, _VP],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgm_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build(path: str) -> None:
    """Compile csrc/*.cu into `path`, one nvcc per source in parallel, then
    link; raises with nvcc's output on failure."""
    global BUILD_INFO
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        nvcc = _nvcc()
        tag = str(os.getpid())
        t0 = time.perf_counter()
        objs, procs, logs, failed = [], [], [], []
        try:
            for src in _sources():
                name = os.path.basename(src)
                obj = os.path.join(BUILD_DIR, f"{name}.{tag}.o")
                objs.append(obj)
                procs.append((name, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            for name, p in procs:
                out, _ = p.communicate(timeout=600)
                logs.append(f"== {name}\n{out}")
                if p.returncode != 0:
                    failed.append(name)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n"
                                   + "\n".join(logs))
            tmp = f"{path}.{tag}.tmp"
            r = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            os.replace(tmp, path)
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        BUILD_INFO = {"seconds": time.perf_counter() - t0,
                      "log": "\n".join(logs)}


def kernels():
    """The loaded kernel library, built first if needed. Once it is loaded
    this takes no lock."""
    lib = _lib
    if lib is not None:
        return lib
    return _load()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                build(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _ENTRIES[name] = fn
            _lib = lib
        return _lib


_ENTRIES = {}


def entry(name: str):
    """The ctypes function of the library's entry point `name` (loading the
    library at first use)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        kernels()
        fn = _ENTRIES[name]
    return fn


def stream(device) -> int:
    """The raw handle (a cudaStream_t as an int) of the current stream of
    the CUDA `device`, which must carry its index (a tensor's device does)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_WAVES = {}


def wave_blocks(name: str, device_index: int, *args: int) -> int:
    """Blocks of one full wave of a persistent kernel's grid (SMs x the
    blocks an SM holds), from its entry point `name` (a gm_*_blocks) called
    with `args`, asked once per device."""
    key = (name, device_index, *args)
    nb = _WAVES.get(key)
    if nb is None:
        with torch.cuda.device(device_index):
            nb = entry(name)(*args)
        if nb <= 0:
            raise RuntimeError(f"{name}: occupancy query failed ({nb})")
        _WAVES[key] = nb
    return nb


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
