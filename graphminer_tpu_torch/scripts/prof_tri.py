"""Kernels S, P and I (ops/cuda_tri.py) against variants, in turns.

Builds the tasks that ops/tri_support.py::tri_support gives S (every DAG
edge), P (sub-core u, core v) and I (both ends sub-core) on rmat(--scale,
16, seed 7) at core 4096 and times, in one process on the card, S, P and
I as built beside their bounds (utils/profiling.py::tri_bitmap_bytes,
::tri_probe_bytes, ::tri_lists_bytes) and what they load
(cuda_tri.bitmap_loads, ::probe_loads, ::list_loads). --first-design DIR
also compiles DIR/graphminer_tpu_torch/csrc/tri_support.cu (an older
checkout's source), and --variant NAME=FILE (repeatable) a copy of
csrc/tri_support.cu with another design or constant (S_WINDOW, P_STEP,
I_LANES, I_IDS), each into a library of its own under graph_cache/, and
times their S, P and I in the same turns (a b c, c b a). Their entry
points must take the built ones' arguments. Every result must equal the
plain version's.
Prints one JSON line: for each variant the event-timed ms of each turn
(CUDA events, median of --reps calls, the host's dispatch included), the
device ms alone (torch.profiler over 200 calls), and the card's name and
power limit.

    python -m graphminer_tpu_torch.scripts.prof_tri [--scale 18]
        [--first-design graph_cache/parent] [--variant NAME=FILE ...]
        [--reps 11]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import _build, cuda_tri
from graphminer_tpu_torch.ops import tri_support as ts
from graphminer_tpu_torch.ops._tensors import n_blocks
from graphminer_tpu_torch.utils import profiling as pf

def tasks(g, core: int = ts.CORE, device="cuda"):
    """(S's arguments, P's arguments, I's arguments) as tri_support makes
    them, on `device`."""
    rg = g.relabel_by_degree(descending=False)
    _, cs, words = ts.core_split(rg, core)
    t = lambda a: torch.from_numpy(a).to(device)
    table = t(ts._pack_full_core_bitmaps(rg, cs, words))
    deg, core_nb = ts.core_neighbours(rg, cs)
    ft = cuda_tri.FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb,
                                   device)
    src, dst = (a.astype(np.int32) for a in rg.orientation().edge_list())
    sc = (src < cs) & (dst >= cs)
    ss = (src < cs) & (dst < cs)
    return ((table, t(src), t(dst)), (ft, table, t(src[sc]), t(dst[sc] - cs)),
            (ft, t(src[ss]), t(dst[ss])))


def compiled(src: str, tag: str):
    """(S, P, I) callables of the CUDA source `src` (which may include the
    package's common.cuh), compiled into graph_cache/libtri_<tag>.so and
    launched as the wrappers launch theirs (S over S_WINDOW tasks a warp's
    worth of blocks, P a thread a task, I I_LANES threads a task)."""
    out_dir = os.path.join(os.path.dirname(_build._PKG), "graph_cache")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libtri_{tag}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-shared", "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    for name in ("gm_tri_bitmap", "gm_tri_probe", "gm_tri_lists"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]

    def s(tab, a, b):
        out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
        n = a.shape[0]
        _build.check_launch(lib.gm_tri_bitmap(
            tab.data_ptr(), tab.shape[0], tab.shape[1], a.data_ptr(),
            b.data_ptr(), n, out.data_ptr(),
            n_blocks(-(-n // cuda_tri.S_WINDOW) * 32),
            _build.stream(a.device)), f"{tag} S")
        return out

    def p(ft, tab, u, vl):
        out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
        n = u.shape[0]
        _build.check_launch(lib.gm_tri_probe(
            ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
            tab.data_ptr(), tab.shape[0], tab.shape[1], u.data_ptr(),
            vl.data_ptr(), n, out.data_ptr(), n_blocks(n),
            _build.stream(u.device)), f"{tag} P")
        return out

    def i(ft, u, w):
        out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
        n = u.shape[0]
        _build.check_launch(lib.gm_tri_lists(
            ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
            ft.n_vertices, u.data_ptr(), w.data_ptr(), n, out.data_ptr(),
            n_blocks(n * cuda_tri.I_LANES), _build.stream(u.device)),
            f"{tag} I")
        return out

    return s, p, i


#: per kernel: its wrapper, plain version, bytes and loads counters
KERNELS = {
    "tri_bitmap": (cuda_tri.tri_bitmap, cuda_tri.tri_bitmap_plain,
                   pf.tri_bitmap_bytes, cuda_tri.bitmap_loads),
    "tri_probe": (cuda_tri.tri_probe, cuda_tri.tri_probe_plain,
                  pf.tri_probe_bytes, cuda_tri.probe_loads),
    "tri_lists": (cuda_tri.tri_lists, cuda_tri.tri_lists_plain,
                  pf.tri_lists_bytes, cuda_tri.list_loads)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--first-design", default=None, metavar="DIR")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE")
    ap.add_argument("--reps", type=int, default=11)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("prof_tri needs a CUDA card")
    args = dict(zip(KERNELS, tasks(rmat(a.scale, 16, seed=7))))
    kernels = {k: {"built": lambda k=k: KERNELS[k][0](*args[k])}
               for k in KERNELS}
    sources = [("first design", os.path.join(
        a.first_design, "graphminer_tpu_torch", "csrc", "tri_support.cu"))
        ] if a.first_design else []
    sources += [tuple(v.split("=", 1)) for v in a.variant]
    for i, (name, path) in enumerate(sources):
        for k, fn in zip(KERNELS, compiled(path, f"variant{i}")):
            kernels[k][name] = lambda fn=fn, k=k: fn(*args[k])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "scale": a.scale, "kernels": {}}
    for name, fns in kernels.items():
        _, plain_fn, bytes_fn, loads_fn = KERNELS[name]
        plain = plain_fn(*args[name])
        nbytes = bytes_fn(*args[name])
        rows = {k: {"event_ms": []} for k in fns}
        order = list(fns) + list(reversed(fns))
        for k in order:                       # turns: a b c, c b a
            ms, val = pf.time_ms(fns[k], "cuda", a.reps)
            if not torch.equal(val, plain):
                raise RuntimeError(f"{name} {k}: result != plain")
            rows[k]["event_ms"].append(ms)
        for k, fn in fns.items():
            rows[k]["device_ms"] = pf.device_ms(fn)[0]
        rows["built"]["loads"] = loads_fn(*args[name])
        out["kernels"][name] = {
            "tasks": args[name][-1].numel(), "bytes": nbytes,
            "bound_ms": pf.bound_ms(nbytes)[0], "variants": rows}
    out["kernels"]["tri_probe"]["once_a_run"] = cuda_tri.probe_loads(
        *args["tri_probe"], window=None)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
