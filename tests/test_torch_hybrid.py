"""Port hybrid engine (graphminer_tpu_torch/ops/hybrid.py: ring phase C +
materialized sub-core stream) against the JAX package's HybridEngine, the
ring and hub-core engines and the brute-force oracle: the non-citeseer
cases of tests/test_hybrid.py. Counts and byte sizes must be equal exactly.
On the CPU kernels A and B take their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import hybrid as jhybrid
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cuda_ring, cuda_stream, hubcore, ring
from graphminer_tpu_torch.ops import stream
from graphminer_tpu_torch.ops.hybrid import (HybridEngine,
                                             triangle_count_hybrid_tier)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def port_layouts(ref):
    """The JAX engine's ring and stream layouts as port layouts on the
    CPU."""
    a, r, s = np.asarray, ref.ring, ref.stream
    port_ring = ring.RingLayout.from_numpy(
        a(r.core_bm), None, [], words=r.words, core_start=r.core_start,
        cbuckets=[(b.wc, a(b.src_bm), a(b.dst_loc), b.row_tasks)
                  for b in r.cbuckets], bbuckets=[], tbuckets=[],
        n_tasks=r.n_tasks, n_core_tasks=r.n_core_tasks,
        n_b_tasks=r.n_b_tasks, device="cpu")
    lay = s.layout
    port_stream = stream.StreamLayout.from_numpy(
        a(lay.table), lay.t_width, words=lay.words,
        core_start=lay.core_start, wt_pad=lay.wt_pad,
        buckets=[(b.spec, a(b.dst_rows), a(b.src_rows), b.row_tasks)
                 for b in s.buckets], n_tasks=s.n_tasks, device="cpu")
    return port_ring, port_stream


def test_hybrid_vs_ring_rmat12():
    g = rmat(12, 16, seed=7)
    want = ring.triangle_count_ring(g, device="cpu")
    assert want == 482_181
    eng = HybridEngine(g, device="cpu")
    assert eng.count() == want
    # the split covers every DAG edge exactly once
    assert eng.ring.n_core_tasks + eng.stream.n_tasks == eng.n_edges
    assert triangle_count_hybrid_tier(g, device="cpu") == want


def test_small_core_forces_stream_tier():
    g = rmat(12, 8, seed=3)
    eng = HybridEngine(g, core=256, device="cpu")
    assert eng.stream.n_tasks > 0 and eng.ring.n_core_tasks > 0
    want = hubcore.triangle_count_fast(g, device="cpu")
    assert eng.count() == want == \
        jhybrid.HybridEngine(jax_graph(g), core=256).count()


@pytest.mark.parametrize("scale,ef,seed,core", [(13, 16, 5, 1024),
                                                (11, 8, 9, 128)])
def test_layouts_and_bytes_equal_jax(scale, ef, seed, core):
    g = rmat(scale, ef, seed=seed)
    ours = HybridEngine(g, core=core, device="cpu")
    ref = jhybrid.HybridEngine(jax_graph(g), core=core)
    assert ours.nbytes() == ref.nbytes()
    assert (ours.ring.nbytes(), ours.stream.nbytes()) == \
        (ref.ring.nbytes(), ref.stream.nbytes())
    assert ours.n_edges == ref.n_edges
    assert [b.wc for b in ours.ring.cbuckets] == list(ref.cspec)
    assert [b.spec for b in ours.stream.buckets] == list(ref.sspec)
    # the tiering: the hybrid's stream is the full stream's sub-core slice
    full = stream.build_stream(g, core=core, plan_only=True)
    assert ours.stream.nbytes() < full
    assert ours.ring.nbytes() < ours.nbytes() < ours.ring.nbytes() + full


def test_grouped_plain_partials_equal_jax_partials():
    """B's and A's grouped plain versions over the JAX package's own
    layouts, summed, against its one-dispatch _hybrid_partials."""
    g = rmat(11, 16, seed=2)
    ref = jhybrid.HybridEngine(jax_graph(g), core=512)
    want = int(np.asarray(ref.partials(), dtype=np.int64).sum())
    eng = HybridEngine.from_layouts(*port_layouts(ref))
    b = int(cuda_ring.ring_phase_c_all_plain(eng.phase_c_plan).sum())
    a = int(cuda_stream.stream_count_all_plain(eng.stream_plan).sum())
    assert b > 0 and a > 0
    assert b + a == want == int(eng.partials().sum()) == eng.count()
    assert eng.nbytes() == ref.nbytes()


def test_core_covers_graph_no_stream_buckets(rand_graphs):
    for jg in rand_graphs:
        g = HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)
        eng = HybridEngine(g, core=4096, device="cpu")
        assert eng.stream.buckets == () and eng.stream.n_tasks == 0
        assert eng.ring.n_core_tasks == eng.n_edges
        assert eng.count() == oracle.triangles(g)


def test_no_core_tasks_launches_only_stream():
    """A DAG whose only edges point below the core: no phase-C bucket."""
    src = np.array([0, 0, 1, 3])
    dst = np.array([1, 2, 2, 4])
    g = HostGraph.from_edges(src, dst, 6)
    g = HostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=True)
    eng = HybridEngine(g, core=1, device="cpu")
    assert eng.ring.cbuckets == () and eng.stream.n_tasks == 4
    assert eng.count() == 1


def test_coverage_check():
    g = rmat(10, 8, seed=4)
    ref = jhybrid.HybridEngine(jax_graph(g), core=256)
    r, s = port_layouts(ref)
    other = stream.build_stream(g, core=256, device="cpu")   # every task
    with pytest.raises(ValueError, match="cover"):
        HybridEngine.from_layouts(r, other)
    assert HybridEngine.from_layouts(r, s).count() == \
        int(np.asarray(jnp.sum(ref.partials().astype(jnp.int64))))
