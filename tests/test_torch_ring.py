"""Port ring engine (graphminer_tpu_torch/ops/ring.py, cuda_ring.py)
against the JAX package's ring engine, its Pallas phase-C kernel in
interpret mode (as tests/test_ring.py runs it on the CPU), the stream
engines and the brute-force oracle. Counts and arrays must be equal."""
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import pallas_ring
from graphminer_tpu.ops import ring as jring
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cuda_ring, ring, stream


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def same(t, a):
    return np.array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("scale,ef,seed,core,phases", [
    (12, 8, 3, 256, "CT"), (12, 16, 7, 4096, "CT"), (11, 8, 19, 4096, "CT"),
    (10, 16, 1, 33, "CT"), (12, 8, 3, 256, "C")])
def test_layout_arrays_equal(scale, ef, seed, core, phases):
    g = rmat(scale, ef, seed=seed)
    ours = ring.build_ring(g, core=core, phases=phases, device="cpu")
    ref = jring.build_ring(jax_graph(g), core=core, phases=phases)
    if "T" not in phases:
        assert not (ours.bbuckets or ours.tbuckets or ours.tail_tables)
    assert (ours.words, ours.core_start, ours.core_size, ours.n_tasks,
            ours.n_core_tasks, ours.n_b_tasks) == (
        ref.words, ref.core_start, ref.core_size, ref.n_tasks,
        ref.n_core_tasks, ref.n_b_tasks)
    assert same(ours.core_bm, ref.core_bm)
    assert (ours.bm_table is None) == (ref.bm_table is None)
    if ours.bm_table is not None:
        assert same(ours.bm_table, ref.bm_table)
    assert len(ours.tail_tables) == len(ref.tail_tables)
    for a, b in zip(ours.tail_tables, ref.tail_tables):
        assert same(a, b)
    for mine, theirs in ((ours.cbuckets, ref.cbuckets),
                         (ours.bbuckets, ref.bbuckets)):
        assert [b.wc for b in mine] == [b.wc for b in theirs]
        for a, b in zip(mine, theirs):
            assert same(a.src_bm, b.src_bm) and same(a.dst_loc, b.dst_loc)
            assert np.array_equal(a.row_tasks, b.row_tasks)
    assert [(b.ta, b.tv, b.n_tasks) for b in ours.tbuckets] == \
        [(b.ta, b.tv, b.n_tasks) for b in ref.tbuckets]
    for a, b in zip(ours.tbuckets, ref.tbuckets):
        assert same(a.src_slot, b.src_slot) and same(a.dst_slot, b.dst_slot)
    assert ours.nbytes() == ref.nbytes()


@pytest.mark.parametrize("scale,seed,core", [(10, 19, 4096), (11, 19, 256)])
def test_phase_c_equals_pallas_interpret_and_xla(scale, seed, core):
    g = rmat(scale, 8, seed=seed)
    ours = ring.build_ring(g, core=core, device="cpu")
    ref = jring.build_ring(jax_graph(g), core=core)
    assert ref.cbuckets
    for a, b in zip(ours.cbuckets, ref.cbuckets):
        got = int(cuda_ring.ring_phase_c(ours.core_bm, a.src_bm, a.dst_loc))
        pallas = int(np.asarray(pallas_ring.cbucket_partials_pallas(
            ref.core_bm, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc,
            interpret=True), dtype=np.int64).sum())
        xla = int(np.asarray(jring._cbucket_partials(
            ref.core_bm, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc,
            per_task=False), dtype=np.int64).sum())
        assert got == pallas == xla, b.wc


@pytest.mark.parametrize("scale,seed,core", [(12, 3, 256), (11, 5, 64)])
def test_bitmap_and_tail_buckets_equal_xla(scale, seed, core):
    g = rmat(scale, 8, seed=seed)
    ours = ring.build_ring(g, core=core, device="cpu")
    ref = jring.build_ring(jax_graph(g), core=core)
    assert ref.bbuckets and ref.tbuckets
    for a, b in zip(ours.bbuckets, ref.bbuckets):
        want = int(np.asarray(jring._cbucket_partials(
            ref.bm_table, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc,
            per_task=False), dtype=np.int64).sum())
        assert int(cuda_ring.ring_phase_c(ours.bm_table, a.src_bm,
                                          a.dst_loc)) == want
    for a, b in zip(ours.tbuckets, ref.tbuckets):
        want = int(np.asarray(jring._tail_pairs_partials(
            ref.tail_tables[b.ta], ref.tail_tables[b.tv], b.src_slot,
            b.dst_slot, per_task=False), dtype=np.int64).sum())
        got = cuda_ring.ring_tail_pairs(
            ours.tail_tables[a.ta], ours.tail_tables[a.tv], a.src_slot,
            a.dst_slot)
        assert got.dtype == torch.int64 and int(got) == want


@pytest.mark.parametrize("core", [1, 8, 16, 1024])
def test_ring_stream_oracle_agree(core, rand_graphs):
    for g in rand_graphs:
        want = oracle.triangles(g)
        assert ring.triangle_count_ring(g, core=core, device="cpu") == want
        assert stream.triangle_count_stream(g, core=core,
                                            device="cpu") == want


@pytest.mark.parametrize("scale,ef,seed,core", [(12, 8, 3, 256),
                                                (13, 8, 11, 4096)])
def test_ring_equals_jax_ring(scale, ef, seed, core):
    g = rmat(scale, ef, seed=seed)
    eng = ring.RingEngine(g, core=core, device="cpu")
    lay = eng.layout
    assert sum(b.n_tasks for b in lay.cbuckets) == lay.n_core_tasks
    want = jring.RingEngine(jax_graph(g), core=core,
                            use_pallas=False).count()
    assert eng.count() == want == stream.triangle_count_stream(
        g, core=core, device="cpu")


def test_count_from_jax_built_arrays():
    g = rmat(11, 8, seed=5)
    ref = jring.build_ring(jax_graph(g), core=64)
    a = np.asarray
    port = ring.RingLayout.from_numpy(
        a(ref.core_bm), a(ref.bm_table), [a(t) for t in ref.tail_tables],
        words=ref.words, core_start=ref.core_start,
        cbuckets=[(b.wc, a(b.src_bm), a(b.dst_loc), b.row_tasks)
                  for b in ref.cbuckets],
        bbuckets=[(b.wc, a(b.src_bm), a(b.dst_loc), b.row_tasks)
                  for b in ref.bbuckets],
        tbuckets=[(b.ta, b.tv, a(b.src_slot), a(b.dst_slot), b.n_tasks)
                  for b in ref.tbuckets],
        n_tasks=ref.n_tasks, n_core_tasks=ref.n_core_tasks,
        n_b_tasks=ref.n_b_tasks, device="cpu")
    assert port.nbytes() == ref.nbytes()
    want = jring.RingEngine(jax_graph(g), core=64, use_pallas=False).count()
    assert ring.RingEngine.from_layout(port).count() == want


def test_rmat14_golden():
    assert ring.triangle_count_ring(rmat(14, 16, seed=7),
                                    device="cpu") == 2_860_691


def test_wrappers_take_plain_only_on_cpu():
    rng = np.random.default_rng(2)
    w = lambda *s: torch.from_numpy(
        rng.integers(-2**31, 2**31, s).astype(np.int32))
    table, src = w(40, 8), w(16, 8)
    dl = torch.from_numpy(rng.integers(-2, 42, (16, 4)).astype(np.int32))
    before = (cuda_ring.ring_phase_c.launches,
              cuda_ring.ring_tail_pairs.launches)
    assert int(cuda_ring.ring_phase_c(table, src, dl)) == \
        int(cuda_ring.ring_phase_c_plain(table, src, dl))
    ta = torch.sort(torch.from_numpy(rng.permutation(64)[:32].astype(
        np.int32)).view(4, 8), dim=1).values
    sl = torch.tensor([0, 1, 3, -1, 7], dtype=torch.int32)
    assert int(cuda_ring.ring_tail_pairs(ta, ta, sl, sl)) == 24
    assert (cuda_ring.ring_phase_c.launches,
            cuda_ring.ring_tail_pairs.launches) == before
    with pytest.raises(ValueError):
        cuda_ring.ring_phase_c(table[:, :4], src, dl)
    with pytest.raises(TypeError):
        cuda_ring.ring_tail_pairs(ta.long(), ta, sl, sl)
