"""Scale-out: task-sharded pattern counting over a mesh of devices.

The counterpart of graphminer_tpu/parallel/mesh.py. Parity with the
reference's distribution tiers:
  * multi-GPU single node (graph replicated, COO task list split by the
    scheduler, one host thread a device, host sum —
    src/clique/multigpu.cu:20-140)            →  mesh axis "chip"
  * MPI multi-node (rank = edge range, MPI_Allreduce —
    src/triangle/dist_gpu.cpp:9-34)           →  mesh axis "host"
  * hierarchical rank×GPU (even_task_split,
    gpu_kernel_wrapper.cu:83-110)             →  2D mesh ("host", "chip")

The CSR graph is replicated on every distinct device of the mesh (one
DeviceGraph each); the edge tasks are assigned to the mesh's shards in
flattened order by parallel/scheduler.py (least_first bin-packing by
default, round_robin chunking otherwise); each shard is counted on its
device by the frontier engine's compact descent (engine/frontier.py), no
kernel of ours, and the shard partials are summed exactly in int64 on the
host (the reference's host sum; JAX's lax.psum). Shards on distinct
devices run at once, one host thread a device, each thread on its own
CUDA stream; a device that appears more than once in the mesh counts its
shards in turn. An exception in any thread is raised to the caller.

Left out: shard_map, jit and the SENTINEL padding of every shard to one
chunk-multiple length (a shard_map artifact: a shard here is its own task
list, padded only to its own chunks).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device_graph import DeviceGraph, to_device
from ..core.plan import Plan
from ..device import resolve_device
from ..engine.frontier import _descend_compact
from ..utils.exec import pad_to_chunks
from .scheduler import least_first, round_robin


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices in a named grid: `devices` is a numpy object array of
    torch.device shaped like the mesh, `axis_names` one name an axis."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))


def _device(d) -> torch.device:
    """A device of the mesh: a CUDA device always with its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple] = None,
              axis_names: tuple = ("host", "chip")) -> Mesh:
    """Mesh over the given devices (any mix of torch.device and device
    strings; one may appear more than once) or, by default, every visible
    CUDA device; shape=None → 1 host × all devices. With no card and no
    devices given it raises: the CPU is used only when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                               "devices=[torch.device('cpu')] to shard on "
                               "the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if shape is None:
        shape = (1, len(devs))
    if len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {shape} for axes {axis_names}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(devices=arr.reshape(shape), axis_names=tuple(axis_names))


def _assign(n: int, src, dst, deg, n_shards: int, chunk: int,
            policy: str) -> List[np.ndarray]:
    if policy == "least_first" and deg is not None and n:
        return least_first(n_shards, deg[src], deg[dst], chunk=chunk)
    return round_robin(n_shards, n, chunk=chunk)


def _shard_tasks(src, dst, deg, n_shards: int, chunk: int,
                 policy: str = "least_first"):
    """[(src, dst)] of each shard: the task chunks that the scheduler
    assigns it, in task order.

    policy="least_first" uses Scheduler-style greedy bin-packing by the
    min(deg(src), deg(dst)) workload estimate (scheduler.cc:133-214);
    "round_robin" is the chunk-cyclic fallback (scheduler.cc:34-85)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    assign = _assign(src.shape[0], src, dst, deg, n_shards, chunk, policy)
    return [(src[idx], dst[idx]) for idx in assign]


def shard_balance(g, n_shards: int, chunk: int = 2048,
                  policy: str = "least_first", sym_break: bool = False):
    """Per-shard (task_count, workload_estimate) under `policy` — the
    dryrun's work-balance evidence. Workload estimate per task is
    min(deg(src), deg(dst)), the same proxy the reference scheduler packs
    by (scheduler.cc:14-20, 133-214)."""
    src, dst = g.edge_list(sym_break=sym_break)
    deg = np.diff(g.rowptr)
    assign = _assign(src.shape[0], src, dst, deg, n_shards, chunk, policy)
    w = np.minimum(deg[src], deg[dst]).astype(np.int64)
    return [(int(idx.shape[0]), int(w[idx].sum())) for idx in assign]


def _count_shard(dg, plan: Plan, src, dst, *, chunk: int, width: int,
                 sub: int, backend: str) -> torch.Tensor:
    """int64 0-d count of one shard's tasks on dg's device."""
    total = torch.zeros((), dtype=torch.int64, device=src.device)
    if not src.shape[0]:
        return total
    for s, d in zip(*pad_to_chunks((src, dst), chunk)):
        total += _descend_compact(dg, plan, 2, torch.stack([s, d], dim=1),
                                  {}, width, sub, backend)
    return total


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """The context a device's thread counts in: its CUDA device and a
    stream of its own (nothing for the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        yield


def count_pattern_sharded(g, plan: Plan, mesh: Optional[Mesh] = None,
                          chunk: int = 2048, sub: Optional[int] = None,
                          backend: str = "auto", width: Optional[int] = None,
                          policy: str = "least_first") -> int:
    """Multi-device exact pattern count: replicated graph, sharded edge
    tasks, an int64 host sum of the shard partials (see the module
    docstring). mesh=None is make_mesh(): every visible card.

    Task→shard assignment goes through parallel/scheduler.py (least_first
    bin-packing by default) so per-shard work is balanced even when the task
    list is not degree-sorted."""
    from ..utils.profiling import PROFILER
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    if mesh is None:
        mesh = make_mesh()
    src, dst = g.edge_list(sym_break=plan.edge_sym_break)
    width = width or max(8, g.max_degree)
    sub_ = sub or chunk
    deg = np.diff(g.rowptr)
    shards = _shard_tasks(src, dst, deg, mesh.devices.size, chunk,
                          policy=policy)
    by_device: Dict[torch.device, List[int]] = {}
    for w, dev in enumerate(mesh.devices.flat):
        by_device.setdefault(dev, []).append(w)

    def run(dev, ws):
        with _on_device(dev):
            dg = DeviceGraph.from_host(g, device=dev)
            parts = [_count_shard(dg, plan, to_device(shards[w][0], dev),
                                  to_device(shards[w][1], dev), chunk=chunk,
                                  width=width, sub=sub_, backend=backend)
                     for w in ws]
            return [int(p) for p in parts]

    PROFILER.count("edge_tasks", int(src.shape[0]))
    with PROFILER.phase("sharded_count"):
        if len(by_device) == 1:
            partials = run(*next(iter(by_device.items())))
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(by_device)) as ex:
                futures = [ex.submit(run, dev, ws)
                           for dev, ws in by_device.items()]
                partials = [p for f in futures for p in f.result()]
    total = int(np.asarray(partials, dtype=np.int64).sum())
    return total // plan.multiplicity
