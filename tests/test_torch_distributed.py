"""Port partitioned and multi-process counting (graphminer_tpu_torch/
parallel/distributed.py) against the JAX package's on the same seeded
graphs: plan_halo_hops over every plan, partitioned counts of TC,
4-cliques, diamonds and 4-cycles, and the multi-process count as 2 and 4
processes spawned over gloo on the CPU, each printing the exact total.

The spawned workers import neither JAX nor tests/conftest.py.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.core import plan as jplan
from graphminer_tpu.parallel import distributed as jdistributed
from graphminer_tpu.workloads.triangle import triangle_count
from graphminer_tpu_torch.core import plan
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the frontier issues many small ops, and under
    xdist the workers' intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@pytest.mark.parametrize("name", sorted(plan.SGL_PLANS) +
                         ["clique3", "clique4", "clique5"])
def test_plan_halo_hops_equal_jax(name):
    if name.startswith("clique"):
        ours, ref = plan.clique_plan(int(name[-1])), \
            jplan.clique_plan(int(name[-1]))
    else:
        ours, ref = plan.SGL_PLANS[name], jplan.SGL_PLANS[name]
    assert distributed.plan_halo_hops(ours) == \
        jdistributed.plan_halo_hops(ref)
    want = {"triangle": 1, "clique3": 1, "clique4": 1, "clique5": 1,
            "diamond": 1, "rectangle": 2, "house": 2, "pentagon": 2}
    if name in want:
        assert distributed.plan_halo_hops(ours) == want[name]


@pytest.mark.parametrize("name,scale,n_parts", [
    ("triangle", 10, 2), ("triangle", 10, 3), ("clique4", 10, 3),
    ("diamond", 9, 2), ("rectangle", 9, 2)])
def test_partitioned_equal_jax(name, scale, n_parts):
    """rectangle takes hops = 2 (its plan walks away from v0)."""
    g = rmat(scale, 8, seed=7)
    if name == "triangle":
        ours, ref = plan.TRIANGLE, jplan.TRIANGLE
    elif name == "clique4":
        ours, ref = plan.clique_plan(4), jplan.clique_plan(4)
    else:
        ours, ref = plan.SGL_PLANS[name], jplan.SGL_PLANS[name]
    want = jdistributed.count_pattern_partitioned(jax_graph(g), ref,
                                                  n_parts)
    assert want > 0
    assert distributed.count_pattern_partitioned(
        g, ours, n_parts, chunk=512, device="cpu") == want


def test_multiprocess_single_process_and_no_card(monkeypatch):
    """Without init_distributed this process is the only one; with no
    card and no device it raises."""
    g = rmat(9, 16, seed=7)
    want = triangle_count(jax_graph(g))
    assert distributed.count_pattern_multiprocess(
        g, plan.TRIANGLE, device="cpu") == want
    distributed.init_distributed()     # no variables set: a no-op
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.count_pattern_multiprocess(g, plan.TRIANGLE)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from graphminer_tpu_torch.core.plan import TRIANGLE
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.parallel.distributed import (
        count_pattern_multiprocess, init_distributed)
    from graphminer_tpu_torch.parallel.partition import induced_partition_1d
    init_distributed()
    rank = torch.distributed.get_rank()
    n = torch.distributed.get_world_size()
    g = rmat(9, 16, seed=7)
    part = induced_partition_1d(g.orientation(), n, hops=1)[rank]
    print(f"STATS rank={rank} owned={part.n_owned} "
          f"local_edges={part.graph.n_edges}", flush=True)
    total = count_pattern_multiprocess(g, TRIANGLE, device="cpu")
    print(f"TOTAL={total}", flush=True)
    print(f"JAX_LOADED={'jax' in sys.modules}", flush=True)
    torch.distributed.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_spawn(tmp_path, nproc):
    """nproc processes over gloo on 127.0.0.1, each counting its own
    induced partition; every one prints the exact global count. The
    processes are bounded by a timeout and killed on expiry."""
    want = triangle_count(jax_graph(rmat(9, 16, seed=7)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, PYTHONPATH=REPO,
                   GRAPHMINER_COORDINATOR=f"127.0.0.1:{port}",
                   GRAPHMINER_NUM_PROCESSES=str(nproc),
                   GRAPHMINER_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=str(tmp_path), env=env, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert f"TOTAL={want}\n" in out, out[-2000:]
        assert f"STATS rank={rank} " in out, out[-2000:]
        assert "JAX_LOADED=False" in out, out[-2000:]
