"""Port stream engine (graphminer_tpu_torch/ops/stream.py, cuda_stream.py)
against the JAX package's stream engine and the brute-force oracle. Counts
and integer arrays must be equal exactly. On the CPU the kernel-A wrapper
takes its plain version, so these run the port's whole engine around it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import stream as jstream
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cuda_stream, stream

CLASSES = (4, 32, 256)
WTV = (0, 16)
KW = dict(classes=CLASSES, wtv_classes=WTV)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def build_pair(g, core):
    ours = stream.build_stream(g, core=core, device="cpu", **KW)
    ref = jstream.build_stream(jax_graph(g), core=core, **KW)
    return ours, ref


@pytest.mark.parametrize("core", [8, 16, 1024])
def test_buckets_equal(core, rand_graphs):
    for g in rand_graphs[1:]:
        ours, ref = build_pair(g, core)
        assert ours.n_tasks == ref.n_tasks
        assert [b.spec for b in ours.buckets] == [b.spec for b in ref.buckets]
        for a, b in zip(ours.buckets, ref.buckets):
            assert (a.n_dst, a.n_tasks) == (b.n_dst, b.n_tasks)
            assert np.array_equal(a.dst_rows.numpy(), np.asarray(b.dst_rows))
            assert np.array_equal(a.src_rows.numpy(), np.asarray(b.src_rows))
            assert np.array_equal(a.row_tasks, b.row_tasks)
        assert ours.nbytes() == ref.nbytes()


@pytest.mark.parametrize("scale,core,classes", [
    (10, 64, CLASSES), (11, 4096, stream.WIDTH_CLASSES),
    (12, 256, stream.WIDTH_CLASSES), (12, 33, CLASSES)])
def test_plan_only_bytes_equal(scale, core, classes):
    g = rmat(scale, 16, seed=7)
    kw = dict(core=core, classes=classes, plan_only=True)
    want = jstream.build_stream(jax_graph(g), **kw)
    assert stream.build_stream(g, **kw) == want
    for below in (g.n_vertices // 2, 7):
        assert stream.build_stream(g, dst_below=below, **kw) == \
            jstream.build_stream(jax_graph(g), dst_below=below, **kw)


def test_plan_only_matches_built_bytes():
    g = rmat(11, 8, seed=2)
    planned = stream.build_stream(g, core=64, plan_only=True, **KW)
    assert planned == stream.build_stream(g, core=64, device="cpu",
                                          **KW).nbytes()


def test_dst_below_buckets_equal():
    g = rmat(10, 8, seed=4)
    kw = dict(core=64, dst_below=600, **KW)
    ours = stream.build_stream(g, device="cpu", **kw)
    ref = jstream.build_stream(jax_graph(g), **kw)
    assert [b.spec for b in ours.buckets] == [b.spec for b in ref.buckets]
    for a, b in zip(ours.buckets, ref.buckets):
        assert np.array_equal(a.src_rows.numpy(), np.asarray(b.src_rows))


@pytest.mark.parametrize("source,core", [("rand", 8), ("rmat9", 64)])
def test_bucket_sums_equal_jax_fused(source, core, rand_graphs):
    g = rand_graphs[3] if source == "rand" else rmat(9, 8, seed=9)
    ours, ref = build_pair(g, core)
    assert any(b.wtv for b in ours.buckets)
    for a, b in zip(ours.buckets, ref.buckets):
        want = int(np.asarray(jstream._bucket_counts_fused(
            b.dst_rows, b.src_rows, words=b.ws, wtv=b.wtv),
            dtype=np.int64).sum())
        got = cuda_stream.stream_bucket_count(a.dst_rows, a.src_rows,
                                              ws=a.ws, wtv=a.wtv)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want, a.spec


@pytest.mark.parametrize("core", [1, 8, 16, 1024])
def test_counts_equal_oracle(core, rand_graphs):
    for g in rand_graphs:
        assert stream.triangle_count_stream(g, core=core, device="cpu",
                                            **KW) == oracle.triangles(g)


def test_default_classes_equal_oracle(rand_graphs):
    for g in rand_graphs:
        assert stream.triangle_count_stream(g, core=16, device="cpu") == \
            oracle.triangles(g)


def test_wta_ladder_off_class_regression():
    """Hand-built DAG from tests/test_stream.py: vertex 0 has 40 sub-core
    out-neighbors (wt_pad = 40, off the wta ladder); only 0→41, 0→42,
    41→42 closes a triangle."""
    src = [0] * 40 + [41, 41]
    dst = list(range(1, 39)) + [41, 42] + [42, 43]
    g = HostGraph.from_edges(np.asarray(src), np.asarray(dst), 64)
    g = dataclasses.replace(g, is_dag=True)
    assert stream.build_stream(g, core=4, device="cpu").layout.wt_pad == 40
    assert stream.StreamEngine(g, core=4, device="cpu").count() == 1


def test_count_from_jax_built_arrays(rand_graphs):
    """The port's count over exactly the arrays the JAX package built."""
    g = rand_graphs[3]
    ref = jstream.build_stream(jax_graph(g), core=16, **KW)
    lay = ref.layout
    port = stream.StreamLayout.from_numpy(
        np.asarray(lay.table), lay.t_width, words=lay.words,
        core_start=lay.core_start, wt_pad=lay.wt_pad,
        buckets=[(b.spec, np.asarray(b.dst_rows), np.asarray(b.src_rows),
                  b.row_tasks) for b in ref.buckets],
        n_tasks=ref.n_tasks, device="cpu")
    assert port.nbytes() == ref.nbytes()
    eng = stream.StreamEngine.from_layout(port)
    want = int(np.asarray(jstream._stream_partials(
        tuple((b.dst_rows, b.src_rows) for b in ref.buckets), jnp.int32(0),
        spec=tuple(b.spec for b in ref.buckets)), dtype=np.int64).sum())
    assert eng.count() == want == oracle.triangles(g)


def test_rmat14_golden():
    g = rmat(14, 16, seed=7)
    eng = stream.StreamEngine(g, device="cpu")
    assert sum(b.n_tasks for b in eng.stream.buckets) == eng.n_edges
    assert eng.count() == 2_860_691


def test_wrapper_takes_plain_only_on_cpu():
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.integers(-2**31, 2**31, (8, 8)).astype(np.int32))
    s = torch.from_numpy(rng.integers(-2**31, 2**31, (8, 4, 8)
                                      ).astype(np.int32))
    before = cuda_stream.stream_bucket_count.launches
    got = cuda_stream.stream_bucket_count(d, s, ws=8, wtv=0)
    assert int(got) == int(cuda_stream.stream_bucket_count_plain(
        d, s, ws=8, wtv=0))
    assert cuda_stream.stream_bucket_count.launches == before
    with pytest.raises(TypeError):
        cuda_stream.stream_bucket_count(d.long(), s.long(), ws=8, wtv=0)
    with pytest.raises(ValueError):
        cuda_stream.stream_bucket_count(d[:4], s, ws=8, wtv=0)
