"""Kernels A-E, m3, m3b, R, X, L, G, Q, S, P, I, W and H against their plain
PyTorch versions on a CUDA card, A, B, C and E also as one grouped launch over many
buckets, G also at 512 words (the dense core) and in clique4's gathered
launch; and the labelled workloads (FSM, query, GKS) and the scale-out
counts, which launch none of them, on the card against the CPU.

These need the card (a CUDA kernel has no interpret mode) and skip without
one; chip_smoke.py runs the same comparisons at the main path's shapes.
Run them on a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

(--noconftest: tests/conftest.py imports JAX, which such a machine may lack.)
"""
import collections

import numpy as np
import pytest
import torch

from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import (cuda_check, cuda_cliquebig,
                                      cuda_cliquek, cuda_colsum, cuda_expand,
                                      cuda_gram, cuda_house, cuda_hubcore,
                                      cuda_ring, cuda_stream, cuda_tri,
                                      cuda_window, fetch, house, rectangle,
                                      tri_support)
from graphminer_tpu_torch.ops.hubcore import TriangleEngine
from graphminer_tpu_torch.ops.ring import RingEngine
from graphminer_tpu_torch.ops.stream import StreamEngine
from graphminer_tpu_torch.workloads import fsm, keyword, query

pytestmark = pytest.mark.cuda
SENTINEL = 0x7FFFFFFF
RowTables = collections.namedtuple("RowTables", "src_rows dst_rows")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def tails(rng, rows, width):
    vals = np.cumsum(rng.integers(1, 12, (rows, width)), axis=1
                     ).astype(np.int32)
    k = rng.integers(0, width + 1, rows)
    vals[np.arange(width)[None, :] >= k[:, None]] = SENTINEL
    return vals


@pytest.mark.parametrize("ws", [8, 32, 128])
@pytest.mark.parametrize("wtv,wta", [(0, 0), (16, 8), (48, 64)])
def test_stream_bucket_count(dev, ws, wtv, wta):
    rng = np.random.default_rng(ws + wtv)
    n, width = 64, 32
    d = np.concatenate([words(rng, n, ws), tails(rng, n, wtv)], axis=1)
    s = np.concatenate([words(rng, n * width, ws),
                        tails(rng, n * width, wta)], axis=1)
    d, s = (torch.from_numpy(d).to(dev),
            torch.from_numpy(s.reshape(n, width, ws + wta)).to(dev))
    before = cuda_stream.stream_bucket_count.launches
    got = cuda_stream.stream_bucket_count(d, s, ws=ws, wtv=wtv)
    assert cuda_stream.stream_bucket_count.launches == before + 1
    assert int(got) == int(cuda_stream.stream_bucket_count_plain(
        d, s, ws=ws, wtv=wtv))


#: (n_rows, width, ws, wtv, wta) per bucket: a one-row bucket, widths 2 and
#: 2048, every ws class, tails narrower and wider than the dst's, an empty one
STREAM_SETS = {
    "mixed": [(1, 2048, 8, 0, 0), (37, 2, 128, 48, 32), (64, 32, 32, 16, 8),
              (200, 8, 8, 16, 16), (5, 512, 128, 0, 0),
              (3, 128, 128, 48, 48), (0, 32, 8, 16, 8), (9, 2, 8, 0, 0)],
    "wide": [(2, 2048, 32, 0, 0), (16, 2048, 8, 0, 0), (1, 2, 8, 0, 0)],
    "tails": [(300, 2, 8, 16, 8), (40, 128, 128, 200, 96),
              (8, 32, 32, 48, 64)],
}


@pytest.mark.parametrize("name", sorted(STREAM_SETS))
def test_stream_count_all(dev, name):
    rng = np.random.default_rng(len(name))
    buckets = []
    for n, width, ws, wtv, wta in STREAM_SETS[name]:
        d = np.concatenate([words(rng, n, ws), tails(rng, n, wtv)], axis=1)
        s = np.concatenate([words(rng, n * width, ws),
                            tails(rng, n * width, wta)], axis=1)
        s[rng.random(n * width) < 0.2, ws:] = SENTINEL
        buckets.append((torch.from_numpy(d).to(dev), torch.from_numpy(
            s.reshape(n, width, ws + wta)).to(dev), ws, wtv))
    plan = cuda_stream.plan_stream(buckets)
    before = cuda_stream.stream_bucket_count.launches
    got = cuda_stream.stream_count_all(plan)
    assert cuda_stream.stream_bucket_count.launches == before + 1
    assert got.dtype == torch.int64 and got.dim() == 1
    assert int(got.sum()) == int(cuda_stream.stream_count_all_plain(plan))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_tail_pairs_all(dev, seed):
    rng = np.random.default_rng(seed)
    tables = {w: torch.from_numpy(tails(rng, 90, w)).to(dev)
              for w in (8, 16, 64, 2048, 4096)}
    groups = []
    for wa, wb, n in [(8, 8, 700), (16, 2048, 90), (2048, 16, 40),
                      (64, 4096, 30), (8, 64, 0), (64, 8, 500)]:
        sa = rng.integers(-2, 92, n).astype(np.int32)
        sb = rng.integers(-2, 92, n).astype(np.int32)
        sa[rng.random(n) < 0.05] = SENTINEL
        groups.append((tables[wa], tables[wb], torch.from_numpy(sa).to(dev),
                       torch.from_numpy(sb).to(dev)))
    plan = cuda_ring.plan_tail_pairs(groups)
    before = cuda_ring.ring_tail_pairs.launches
    got = cuda_ring.ring_tail_pairs_all(plan)
    assert cuda_ring.ring_tail_pairs.launches == before + 1
    assert got.dtype == torch.int64 and got.dim() == 1
    assert int(got.sum()) == int(cuda_ring.ring_tail_pairs_all_plain(plan))


@pytest.mark.parametrize("wc", [4, 16, 64, 256, 1024, 4096])
def test_ring_phase_c(dev, wc):
    rng = np.random.default_rng(wc)
    table, src = words(rng, 4096, 128), words(rng, 64, 128)
    dl = rng.integers(-3, 4099, (64, wc)).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (table, src, dl)]
    assert int(cuda_ring.ring_phase_c(*args)) == \
        int(cuda_ring.ring_phase_c_plain(*args))


#: (table, n rows, wc) per bucket: the 4096-row core table (staged), a
#: 20,000-row bitmap table (read in place), one-row and empty buckets, wc 4
#: to 4096
PHASE_C_SETS = {
    "mixed": [("core", 1, 4), ("core", 300, 16), ("bm", 500, 64),
              ("core", 40, 256), ("bm", 3, 4), ("core", 0, 16),
              ("core", 2, 4096)],
    "bitmap only": [("bm", 900, 16), ("bm", 60, 1024)],
}


@pytest.mark.parametrize("name", sorted(PHASE_C_SETS))
def test_ring_phase_c_all(dev, name):
    rng = np.random.default_rng(len(name))
    tables = {"core": words(rng, 4096, 128), "bm": words(rng, 20000, 128)}
    groups = []
    for key, n, wc in PHASE_C_SETS[name]:
        src = words(rng, n, 128)
        src.reshape(n, 16, 8)[rng.random((n, 16)) < 0.5] = 0
        dl = rng.integers(-3, tables[key].shape[0] + 3, (n, wc)
                          ).astype(np.int32)
        dl[rng.random((n, wc)) < 0.1] = SENTINEL
        groups.append(tuple(torch.from_numpy(x).to(dev)
                            for x in (tables[key], src, dl)))
    plan = cuda_ring.plan_phase_c(groups)
    before = cuda_ring.ring_phase_c.launches
    got = cuda_ring.ring_phase_c_all(plan)
    assert cuda_ring.ring_phase_c.launches == before + 1
    assert got.dtype == torch.int64 and got.dim() == 1
    assert int(got.sum()) == int(cuda_ring.ring_phase_c_all_plain(plan))


@pytest.mark.parametrize("nw,wt", [(128, 48), (8, 8), (32, 0)])
def test_hub_tail_count_all(dev, nw, wt):
    rng = np.random.default_rng(nw + wt)
    sr = np.concatenate([words(rng, 400, nw), tails(rng, 400, wt)], 1)
    dr = np.concatenate([words(rng, 200, nw), tails(rng, 200, wt)], 1)
    tables = RowTables(*(torch.from_numpy(x).to(dev) for x in (sr, dr)))
    arrays, spec = [], []
    for n, wa, wb in [(3000, 16, 16), (1, 64, 16), (0, 16, 64),
                      (5000, 0, 0), (700, 16, 1024)]:
        su = rng.integers(-2, 402, n + 50).astype(np.int32)
        dv = np.sort(rng.integers(-2, 202, n + 50)).astype(np.int32)
        su[n:] = dv[n:] = SENTINEL
        arrays.append((torch.from_numpy(su).to(dev),
                       torch.from_numpy(dv).to(dev)))
        spec.append((wa, wb, n + 50))
    plan = cuda_hubcore.plan_tail_count(tables, arrays, spec, nw)
    before = cuda_hubcore.hub_tail_count.launches
    got = cuda_hubcore.hub_tail_count_all(plan)
    assert cuda_hubcore.hub_tail_count.launches == before + 1
    assert got.dtype == torch.int64 and got.dim() == 1
    assert int(got.sum()) == int(cuda_hubcore.hub_tail_count_all_plain(plan))


@pytest.mark.parametrize("wa,wb", [(8, 8), (64, 2048), (2048, 16)])
def test_ring_tail_pairs(dev, wa, wb):
    rng = np.random.default_rng(wa * wb)
    ta, tb = tails(rng, 100, wa), tails(rng, 80, wb)
    sa = rng.integers(-2, 102, 500).astype(np.int32)
    sb = rng.integers(-2, 82, 500).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (ta, tb, sa, sb)]
    assert int(cuda_ring.ring_tail_pairs(*args)) == \
        int(cuda_ring.ring_tail_pairs_plain(*args))


@pytest.mark.parametrize("w", [8, 6, 128, 256])
@pytest.mark.parametrize("n_buf", fetch.N_BUF)
def test_fetch_rows_sum(dev, w, n_buf):
    rng = np.random.default_rng(w * n_buf)
    table = rng.integers(-1000, 1000, (3000, w)).astype(np.int32)
    idx = rng.integers(-3, 3003, 20000).astype(np.int32)
    table, idx = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
    before = fetch.fetch_rows_sum.launches
    got = fetch.fetch_rows_sum(idx, table, n_buf)
    assert fetch.fetch_rows_sum.launches == before + 1
    assert torch.equal(got, fetch.fetch_rows_sum_plain(idx, table))


@pytest.mark.parametrize("w,t", [(1024, 5000), (3, 1), (8, 0), (36, 70000)])
def test_fetch_rows_sum_edges(dev, w, t):
    """The widest rows a block takes, 4-byte lanes, an empty and a one-row
    index list; and the workspace is left zero for the next call."""
    rng = np.random.default_rng(w + t)
    table = torch.from_numpy(rng.integers(-9, 9, (700, w)).astype(np.int32)
                             ).to(dev)
    idx = torch.from_numpy(rng.integers(0, 700, t).astype(np.int32)).to(dev)
    for _ in range(2):
        assert torch.equal(fetch.fetch_rows_sum(idx, table, 4),
                           fetch.fetch_rows_sum_plain(idx, table))


def _device_ops(fn):
    """{device op name: events a call} of fn over 40 calls
    (torch.profiler, which can miss an event at the edge of its window,
    so a count a call may read a little under its true value)."""
    from graphminer_tpu_torch.utils.profiling import device_ms
    return device_ms(fn, calls=40)[1]


def test_fetch_rows_sum_is_one_kernel(dev):
    """A D call runs its kernel and no other device op (a memset at most);
    that it launches once a call, the launch counter shows."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.integers(0, 99, (4096, 32)).astype(np.int32)
                             ).to(dev)
    idx = torch.from_numpy(rng.integers(0, 4096, 9000).astype(np.int32)
                           ).to(dev)
    before = fetch.fetch_rows_sum.launches
    ops = _device_ops(lambda: fetch.fetch_rows_sum(idx, table, 16))
    assert fetch.fetch_rows_sum.launches == before + 50
    kernels = {k: v for k, v in ops.items() if "emset" not in k}
    assert len(kernels) == 1 and 0.9 <= next(iter(kernels.values())) <= 1.0
    assert "fetch_rows_sum_kernel" in next(iter(kernels)), ops
    assert sum(v for k, v in ops.items() if "emset" in k) <= 1.0, ops


def test_fetch_rows_sum_overflow_raises(dev):
    """A column sum outside int32 is a device-side assert, as
    torch._assert_async raises one; it poisons the CUDA context, so it runs
    in a process of its own."""
    import os
    import subprocess
    import sys
    code = ("import torch\n"
            "from graphminer_tpu_torch.ops import fetch\n"
            "t = torch.full((2, 4), 1 << 30, dtype=torch.int32, "
            "device='cuda')\n"
            "i = torch.tensor([0, 1, 0], dtype=torch.int32, device='cuda')\n"
            "fetch.fetch_rows_sum(i, t)\n"
            "torch.cuda.synchronize()\n"
            "print('no error')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=300,
                       capture_output=True, text=True)
    assert r.returncode != 0 and "no error" not in r.stdout
    assert "device-side assert" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("nw,wt,wa,wb", [(128, 48, 64, 16), (128, 48, 16, 16),
                                         (8, 8, 0, 0), (32, 16, 16, 1024)])
def test_hub_tail_count(dev, nw, wt, wa, wb):
    rng = np.random.default_rng(nw + wa)
    sr = np.concatenate([words(rng, 400, nw), tails(rng, 400, wt)], 1)
    dr = np.concatenate([words(rng, 200, nw), tails(rng, 200, wt)], 1)
    su = rng.integers(-2, 402, 5000).astype(np.int32)
    su[::13] = SENTINEL
    dv = np.sort(rng.integers(-2, 202, 5000)).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (sr, dr, su, dv)]
    kw = dict(words=nw, wa=wa, wb=wb)
    assert int(cuda_hubcore.hub_tail_count(*args, **kw)) == \
        int(cuda_hubcore.hub_tail_count_plain(*args, **kw))


@pytest.mark.parametrize("rows_per_step", [1, 8])
@pytest.mark.parametrize("w,span", [(8, 256), (128, 1024), (16, 4096)])
def test_window_count(dev, rows_per_step, w, span):
    rng = np.random.default_rng(w + span)
    nck, cap, nd = 6, 1024, 5000
    args = [torch.from_numpy(x).to(dev) for x in (
        words(rng, nck * cap, w).reshape(nck, cap, w), words(rng, nd, w),
        rng.integers(-50, nd + 50, nck).astype(np.int32),
        rng.integers(-2, span + 2, (nck, cap)).astype(np.int32))]
    before = cuda_window.window_count.launches[rows_per_step]
    assert torch.equal(
        cuda_window.window_count(*args, span=span,
                                 rows_per_step=rows_per_step),
        cuda_window.window_count_plain(*args, span=span))
    assert cuda_window.window_count.launches[rows_per_step] == before + 1


#: (nck, cap, span, w, nd): chunk counts that are no multiple of the wave
#: (one chunk; more chunks than blocks), cap no multiple of a pass of task
#: rows, a narrow window (W = 8), and W = 12 (3 chunks a row)
WINDOW_EDGES = [(1, 8192, 1024, 128, 57344), (300, 520, 300, 8, 1000),
                (7, 1000, 1000, 128, 1500), (5, 77, 10, 12, 40),
                (133, 64, 512, 32, 600)]


@pytest.mark.parametrize("rows_per_step", [1, 8])
@pytest.mark.parametrize("nck,cap,span,w,nd", WINDOW_EDGES)
def test_window_count_edges(dev, rows_per_step, nck, cap, span, w, nd):
    rng = np.random.default_rng(nck + cap + w)
    lidx = np.sort(rng.integers(-3, span + 3, (nck, cap)), axis=1)
    args = [torch.from_numpy(x).to(dev) for x in (
        words(rng, nck * cap, w).reshape(nck, cap, w), words(rng, nd, w),
        rng.integers(-50, nd + 50, nck).astype(np.int32),
        lidx.astype(np.int32))]
    want = cuda_window.window_count_plain(*args, span=span)
    for _ in range(2):                       # the workspace is left zero
        assert torch.equal(cuda_window.window_count(
            *args, span=span, rows_per_step=rows_per_step), want)


@pytest.mark.parametrize("nck,cap", [(0, 64), (4, 0)])
def test_window_count_no_tasks(dev, nck, cap):
    """No tasks: zeros, one a chunk, and no launch."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    before = dict(cuda_window.window_count.launches)
    got = cuda_window.window_count(z(nck, cap, 8), z(16, 8), z(nck),
                                   z(nck, cap), span=4, rows_per_step=1)
    assert got.tolist() == [0] * nck
    assert cuda_window.window_count.launches == before


def test_window_count_is_one_kernel(dev):
    """A window_count call runs its kernel and no other device op; that it
    launches once a call, test_window_count shows."""
    rng = np.random.default_rng(6)
    nck, cap, span, w, nd = 20, 2048, 1024, 128, 8000
    args = [torch.from_numpy(x).to(dev) for x in (
        words(rng, nck * cap, w).reshape(nck, cap, w), words(rng, nd, w),
        rng.integers(0, nd, nck).astype(np.int32),
        rng.integers(0, span, (nck, cap)).astype(np.int32))]
    for r in cuda_window.ROWS_PER_STEP:
        ops = _device_ops(lambda: cuda_window.window_count(
            *args, span=span, rows_per_step=r))
        assert len(ops) == 1 and "window_count_kernel" in next(iter(ops)), ops
        assert 0.9 <= next(iter(ops.values())) <= 1.0, ops


def test_times_two(dev):
    x = torch.from_numpy(words(np.random.default_rng(0), 8, 128)).to(dev)
    assert torch.equal(cuda_check.times_two(x), cuda_check.times_two_plain(x))


def test_engine_counts_launch_a_and_c_once(dev):
    g = rmat(12, 16, seed=7)
    se = StreamEngine(g, core=256, device=dev)
    re_ = RingEngine(g, core=256, device=dev)
    assert len(se.stream.buckets) > 1 and len(re_.layout.tbuckets) > 1
    a, c = (cuda_stream.stream_bucket_count.launches,
            cuda_ring.ring_tail_pairs.launches)
    want = StreamEngine(g, core=256, device="cpu").count()
    assert se.count() == want and re_.count() == want
    assert (cuda_stream.stream_bucket_count.launches,
            cuda_ring.ring_tail_pairs.launches) == (a + 1, c + 1)


def test_engine_counts_launch_b_and_e_once(dev):
    g = rmat(12, 16, seed=7)
    re_ = RingEngine(g, core=256, device=dev)
    he = TriangleEngine(g, core=256, chunk=1024, device=dev)
    assert len(re_.layout.cbuckets) + len(re_.layout.bbuckets) > 1
    assert len(he.spec) > 1
    b, e = cuda_ring.ring_phase_c.launches, cuda_hubcore.hub_tail_count.launches
    want = StreamEngine(g, core=256, device="cpu").count()
    assert re_.count() == want and he.count() == want
    assert (cuda_ring.ring_phase_c.launches,
            cuda_hubcore.hub_tail_count.launches) == (b + 1, e + 1)


def test_engines_rmat14_golden(dev):
    g = rmat(14, 16, seed=7)
    assert StreamEngine(g, device=dev).count() == 2_860_691
    assert RingEngine(g, device=dev).count() == 2_860_691
    eng = TriangleEngine(g, device=dev)
    before = cuda_hubcore.hub_tail_count.launches
    assert eng.count() == 2_860_691
    assert cuda_hubcore.hub_tail_count.launches > before
    assert eng.count_tail() + eng.count_core() == 2_860_691


def test_hybrid_launches_a_and_b_once(dev):
    from graphminer_tpu_torch.ops.hybrid import HybridEngine
    g = rmat(12, 16, seed=7)
    eng = HybridEngine(g, core=1024, device=dev)
    plain = HybridEngine(g, core=1024, device="cpu")
    assert eng.ring.cbuckets and eng.stream.buckets
    before = {f: f.launches for f in (
        cuda_stream.stream_bucket_count, cuda_ring.ring_phase_c,
        cuda_ring.ring_tail_pairs, cuda_hubcore.hub_tail_count)}
    assert eng.count() == plain.count() == 482_181
    assert {f: f.launches - n for f, n in before.items()} == {
        cuda_stream.stream_bucket_count: 1, cuda_ring.ring_phase_c: 1,
        cuda_ring.ring_tail_pairs: 0, cuda_hubcore.hub_tail_count: 0}
    assert int(cuda_ring.ring_phase_c_all(eng.phase_c_plan).sum()) == \
        int(cuda_ring.ring_phase_c_all_plain(plain.phase_c_plan).sum())
    assert int(cuda_stream.stream_count_all(eng.stream_plan).sum()) == \
        int(cuda_stream.stream_count_all_plain(plain.stream_plan).sum())


@pytest.mark.parametrize("backend", ["bc", "bs"])
def test_generic_tc_on_card(dev, backend):
    from graphminer_tpu_torch.workloads.triangle import triangle_count
    g = rmat(12, 16, seed=7)
    assert triangle_count(g, backend=backend, device=dev) == 482_181


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("hw,ld,n", [(1, 1, 37), (2, 8, 100), (16, 24, 1000),
                                     (32, 32, 64), (128, 136, 333)])
def test_expand_bits(dev, hw, ld, n, transpose):
    """Plain mode on a strided slice, n no multiple of 8, bit-31 words,
    n_out padding; one launch a call."""
    rng = np.random.default_rng(hw + ld)
    table = torch.from_numpy(words(rng, n, ld)).to(dev)
    view = table[:, ld - hw:]
    n_out = -(-(n + 5) // 32) * 32
    before = cuda_expand.expand_bits.launches
    got = cuda_expand.expand_bits(view, n_out=n_out, transpose=transpose)
    assert cuda_expand.expand_bits.launches == before + 1
    want = cuda_expand.expand_bits_plain(view, n_out=n_out,
                                         transpose=transpose)
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 6])
def test_expand_bits_gathered(dev, depth, transpose):
    """Gathered mode, explicit rows and rows by task, with SENTINEL and
    out-of-range ids."""
    rng = np.random.default_rng(depth)
    hw, nb, nt, n = 16, 300, 700, 2000
    base = torch.from_numpy(words(rng, nb, hw + 16)).to(dev)[:, 16:]
    tab = torch.from_numpy(words(rng, nt, hw)).to(dev)
    cols = rng.integers(-2, nt + 2, (n, depth)).astype(np.int32)
    if depth:
        cols[::9, 0] = SENTINEL
    r = rng.integers(-2, nb + 2, n).astype(np.int32)
    r[::13] = SENTINEL
    cols, r = torch.from_numpy(cols).to(dev), torch.from_numpy(r).to(dev)
    for kw in (dict(r=r), {}):
        args = dict(tab=tab, cols=cols, n_out=2016, transpose=transpose,
                    **kw)
        before = cuda_expand.expand_bits.launches
        got = cuda_expand.expand_bits(base, **args)
        assert cuda_expand.expand_bits.launches == before + 1
        assert torch.equal(got, cuda_expand.expand_bits_plain(base, **args))


@pytest.mark.parametrize("nrow", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("words_", [8, 128])
def test_lo_popcount(dev, nrow, words_):
    """Random tasks (runs of length 1 mostly), ids outside the tables and
    SENTINEL rows."""
    rng = np.random.default_rng(nrow * words_)
    v, c, n = 3000, 900, 20000
    bm = torch.from_numpy(words(rng, v, words_)).to(dev)
    core = bm[v - c:]
    cols = np.concatenate([rng.integers(-1, v + 1, (n, 2)),
                           rng.integers(-2, c + 2, (n, nrow - 2))], axis=1
                          ).astype(np.int32)
    cols[-100:] = SENTINEL
    runs = cuda_cliquek.lo_runs(cols, device=dev)
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(bm, core, runs)
    assert cuda_cliquek.lo_popcount.launches == before + 1
    assert int(got.sum()) == int(cuda_cliquek.lo_popcount_plain(
        bm, core, runs).sum()) > 0


def run_tasks(rng, nrow, vary_col, v, c, lengths):
    """Tasks in runs of the given lengths: each run's shared ids drawn
    once, the varying id per task, some varying ids outside their table."""
    parts = []
    for ln in lengths:
        lo = np.concatenate([rng.integers(0, v, 2),
                             rng.integers(0, c, nrow - 2)])
        run = np.repeat(lo[None, :], ln, axis=0)
        lim = v if vary_col < 2 else c
        run[:, vary_col] = rng.integers(-1, lim + 1, ln)
        parts.append(run)
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("nrow", [2, 3, 4, 5, 6, 7, 8])
def test_lo_popcount_runs(dev, nrow):
    """Runs of 1 to 5000 tasks (long runs span many work items and
    blocks), an all-zero shared AND, SENTINEL padding; the varying column
    2, or 1 when there is no core column."""
    rng = np.random.default_rng(100 + nrow)
    v, c, w = 5000, 4096, 128
    vc = 2 if nrow > 2 else 1
    bm_np = words(rng, v, w) | words(rng, v, w)
    bm_np[7] = 0
    lengths = rng.choice([1, 1, 2, 3, 17, 130, 700, 5000], 400)
    cols = run_tasks(rng, nrow, vc, v, c, lengths)
    cols[:50, 0] = 7                              # z == 0 for these tasks
    cols = np.concatenate([cols, np.full((4096, nrow), SENTINEL, np.int32)])
    bm = torch.from_numpy(bm_np).to(dev)
    runs = cuda_cliquek.lo_runs(cols, vc, device=dev)
    assert runs.n_runs < cols.shape[0] // 10
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(bm, bm[v - c:], runs)
    assert cuda_cliquek.lo_popcount.launches == before + 1
    assert int(got.sum()) == int(cuda_cliquek.lo_popcount_plain(
        bm, bm[v - c:], runs).sum()) > 0


def test_lo_popcount_no_tasks(dev):
    bm = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    runs = cuda_cliquek.lo_runs(np.zeros((0, 4), np.int32), device=dev)
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(bm, bm[32:], runs)
    assert cuda_cliquek.lo_popcount.launches == before
    assert int(got.sum()) == 0


def gram_inputs(rng, dev, hw, depth, n):
    """Strided views of random rows (every word's bit 31 in play), a tab,
    ids with SENTINEL and out-of-range entries, and a random mask that is
    not triangular, with an empty row tile when it has several."""
    nb, nt = 3000, 2000
    base = torch.from_numpy(words(rng, nb, hw + 4)).to(dev)[:, 4:]
    tab = torch.from_numpy(words(rng, nt, hw + 8)).to(dev)[:, :hw]
    r = rng.integers(-2, nb + 2, n).astype(np.int32)
    r[::29] = SENTINEL
    cols = rng.integers(-2, nt + 2, (n, depth)).astype(np.int32)
    if depth:
        cols[::31, depth - 1] = SENTINEL
    nm = 32 * hw - 3
    mask_np = words(rng, nm, hw + 4) & words(rng, nm, hw + 4)
    if hw >= 8:
        mask_np[128:256] = 0
    mask = torch.from_numpy(mask_np).to(dev)[:, 2:hw + 2]
    kw = dict(r=torch.from_numpy(r).to(dev),
              tab=tab if depth else None,
              cols=torch.from_numpy(cols).to(dev) if depth else None)
    return base, mask, kw


@pytest.mark.parametrize("hw", [4, 16, 32, 128])
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 6])
def test_bit_gram(dev, depth, hw):
    """G == its plain version, max abs error 0: gathered rows at every
    depth (depth 0 with explicit rows) and plain rows (3000), strided
    views, n no multiple of the K-range, invalid ids, a non-triangular mask; one
    launch a call."""
    rng = np.random.default_rng(depth * 1000 + hw)
    n = 70_001 if hw <= 32 else 9_001
    base, mask, kw = gram_inputs(rng, dev, hw, depth, n)
    plan = cuda_gram.plan_gram(mask)
    calls = [kw] + ([dict()] if depth == 0 else [])
    for args in calls:
        before = cuda_gram.bit_gram.launches
        got = cuda_gram.bit_gram(base, mask, plan=plan, **args)
        assert cuda_gram.bit_gram.launches == before + 1
        want = cuda_gram.bit_gram_plain(base, mask, **args)
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert int(got.sum()) > 0


@pytest.mark.parametrize("hw", [1, 2, 5, 6])
def test_bit_gram_ragged(dev, hw):
    """Widths no multiple of the 4-word tile side (the kernel's scalar
    loads), contiguous rows; no task launches nothing."""
    rng = np.random.default_rng(hw)
    base = torch.from_numpy(words(rng, 5000, hw)).to(dev)
    mask = torch.from_numpy(words(rng, 32 * hw, hw)).to(dev)
    got = cuda_gram.bit_gram(base, mask)
    assert torch.equal(got, cuda_gram.bit_gram_plain(base, mask))
    before = cuda_gram.bit_gram.launches
    assert int(cuda_gram.bit_gram(base[:0], mask).sum()) == 0
    assert cuda_gram.bit_gram.launches == before


def test_bit_gram_512_words_self_mask(dev):
    """G at 512 words (dim 16384, the hybrid's default core) with base =
    mask = the packed DAG rows of the rmat14 graph, whole (all of it is
    core), as ops/dense_core.py calls it: == plain, one launch, and the
    sum is rmat14's triangle count; then the hybrid count on the card."""
    from graphminer_tpu_torch.ops import dense_core
    from graphminer_tpu_torch.workloads.triangle import triangle_count_hybrid
    g = rmat(14, 16, seed=7)
    rg = g.relabel_by_degree(descending=False).orientation()
    d = dense_core.core_rows(rg, 0, dev)
    assert d.shape == (16384, 512)
    plan = cuda_gram.plan_gram(d)
    before = cuda_gram.bit_gram.launches
    got = cuda_gram.bit_gram(d, d, plan=plan)
    assert cuda_gram.bit_gram.launches == before + 1
    assert torch.equal(got, cuda_gram.bit_gram_plain(d, d))
    assert int(got.sum()) == 2_860_691
    before = cuda_gram.bit_gram.launches
    assert triangle_count_hybrid(g, device=dev) == 2_860_691
    assert cuda_gram.bit_gram.launches == before + 1


def test_clique4_gathered_on_card(dev):
    """Clique4Engine: one G launch a count in its gathered mode (depth 1,
    the layout table's core rows as the mask), == its plain version, and
    the count == the CPU's."""
    from graphminer_tpu_torch.ops.clique4 import Clique4Engine
    g = rmat(12, 8, seed=23)
    eng = Clique4Engine(g, core=256, device=dev)
    base, mask, kw = eng.gram_args()
    before = cuda_gram.bit_gram.launches
    want = Clique4Engine(g, core=256, device="cpu").count()
    assert eng.count() == want
    assert cuda_gram.bit_gram.launches == before + 1
    assert torch.equal(eng.core_partials(),
                       cuda_gram.bit_gram_plain(base, mask, **kw))


def test_scale_out_on_card(dev):
    """The sharded count on a mesh that repeats the card, the partitioned
    count and the segmented count on the card == the CPU's; none launches
    a kernel of ours."""
    from graphminer_tpu_torch.core.plan import SGL_PLANS, TRIANGLE
    from graphminer_tpu_torch.parallel import distributed, mesh, partition
    g = rmat(11, 16, seed=7)
    m = mesh.make_mesh(devices=[dev] * 4, shape=(2, 2))
    before = cuda_gram.bit_gram.launches
    for plan in (TRIANGLE, SGL_PLANS["diamond"]):
        cpu = mesh.make_mesh(devices=["cpu"])
        assert mesh.count_pattern_sharded(g, plan, mesh=m) == \
            mesh.count_pattern_sharded(g, plan, mesh=cpu)
    assert distributed.count_pattern_partitioned(
        g, SGL_PLANS["rectangle"], 2, device=dev) == \
        distributed.count_pattern_partitioned(
            g, SGL_PLANS["rectangle"], 2, device="cpu")
    assert partition.triangle_count_segmented(g, 4, device=dev) == \
        partition.triangle_count_segmented(g, 4, device="cpu")
    assert cuda_gram.bit_gram.launches == before


@pytest.mark.parametrize("k", [4, 5])
def test_cliquek_engine_on_card(dev, k):
    """rmat12 with a small core: a real lo population and tail; the card's
    count equals the CPU's; the build launches no X, the count G once, L
    once and X never; the slab form (X + torch._int_mm) agrees row for
    row."""
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    from graphminer_tpu_torch.ops.slab_form import CliqueSlab
    g = rmat(12, 8, seed=23)
    x = cuda_expand.expand_bits.launches
    eng = CliqueKEngine(g, k, core=256, hi=64, device=dev)
    assert cuda_expand.expand_bits.launches == x
    want = CliqueKEngine(g, k, core=256, hi=64, device="cpu").count()
    yard = CliqueSlab(eng, slab=4096)
    assert eng.n_lo > 0 and yard.n_slabs > 1
    lo, gr = cuda_cliquek.lo_popcount.launches, cuda_gram.bit_gram.launches
    assert eng.count() == want
    assert (cuda_expand.expand_bits.launches - x,
            cuda_cliquek.lo_popcount.launches - lo,
            cuda_gram.bit_gram.launches - gr) == (0, 1, 1)
    assert torch.equal(yard.hi_partials(), eng.hi_partials())


def test_hub_core_spoke_on_x(dev):
    """The hub-core count: one launch of E, one of G (the spoke) and none
    of X; the spoke by G equals the CPU's and the slab form's (X +
    torch._int_mm)."""
    g = rmat(12, 16, seed=7)
    eng = TriangleEngine(g, core=1024, device=dev)
    before = (cuda_hubcore.hub_tail_count.launches,
              cuda_gram.bit_gram.launches, cuda_expand.expand_bits.launches)
    assert eng.count() == 482_181
    after = (cuda_hubcore.hub_tail_count.launches,
             cuda_gram.bit_gram.launches, cuda_expand.expand_bits.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    assert torch.equal(eng.core_partials(), eng.core_partials_slab())
    assert eng.count_core() == \
        TriangleEngine(g, core=1024, device="cpu").count_core()


def quad_case(rng, dev, w, n=20000, e=5000, c=3000, shift=0):
    """Q's inputs: rows with bit 31 in play, ids outside their tables,
    n_bits inside a word; off from the tasks' bit counts (0 for a task
    with an invalid id), starting past 2^31. With shift > 0 the rows are
    views that start `shift` words into wider tables."""
    y2 = torch.from_numpy(words(rng, e, w + shift)).to(dev)[:, shift:]
    core = torch.from_numpy(words(rng, c, w + shift)).to(dev)[:, shift:]
    erow = rng.integers(-2, e + 2, n).astype(np.int32)
    c1 = rng.integers(-2, c + 2, n).astype(np.int32)
    erow[::41] = SENTINEL
    n_bits = 32 * w - 7
    ok = (erow >= 0) & (erow < e) & (c1 >= 0) & (c1 < c)
    y = (y2.cpu().numpy()[np.where(ok, erow, 0)] &
         core.cpu().numpy()[np.where(ok, c1, 0)])
    bits = np.unpackbits(y.view(np.uint8), axis=1, bitorder="little")
    counts = bits[:, :n_bits].sum(axis=1) * ok
    off = cuda_cliquebig.quad_offsets(torch.from_numpy(counts)) + \
        (1 << 31) + 3
    t = lambda a: torch.from_numpy(a).to(dev)
    return y2, core, t(erow), t(c1), off.to(dev), n_bits


@pytest.mark.parametrize("w", [8, 32, 128])
def test_quad_emit(dev, w):
    """Q == its plain version (max abs error 0), one launch a call; a call
    with no task launches nothing."""
    rng = np.random.default_rng(w)
    args = quad_case(rng, dev, w)
    before = cuda_cliquebig.quad_emit.launches
    r, cols = cuda_cliquebig.quad_emit(*args)
    assert cuda_cliquebig.quad_emit.launches == before + 1
    rp, cp = cuda_cliquebig.quad_emit_plain(*args)
    assert r.numel() > 0 and torch.equal(r, rp) and torch.equal(cols, cp)
    assert bool((cols[:, 1] % 32 == 31).any())
    y2, core, erow, c1, off, n_bits = args
    r, cols = cuda_cliquebig.quad_emit(y2, core, erow[:0], c1[:0], off[:1],
                                       n_bits)
    assert r.numel() == 0 and cuda_cliquebig.quad_emit.launches == before + 1


@pytest.mark.parametrize("w,shift", [(8, 0), (32, 4), (128, 0), (128, 4),
                                     (160, 0)])
def test_quad_count(dev, w, shift):
    """Q's count == its plain version and the bit counts, one launch a
    call, on aligned tables and on views 4 words into wider ones, and on
    rows wider than one warp load (160 words); the emit == plain on the
    same."""
    rng = np.random.default_rng(100 + w + shift)
    y2, core, erow, c1, off, n_bits = quad_case(rng, dev, w, shift=shift)
    before = cuda_cliquebig.quad_count.launches
    got = cuda_cliquebig.quad_count(y2, core, erow, c1, n_bits)
    assert cuda_cliquebig.quad_count.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, cuda_cliquebig.quad_count_plain(
        y2, core, erow, c1, n_bits))
    assert torch.equal(got.long(), off[1:] - off[:-1])
    args = (y2, core, erow, c1, off, n_bits)
    for kv, pv in zip(cuda_cliquebig.quad_emit(*args),
                      cuda_cliquebig.quad_emit_plain(*args)):
        assert torch.equal(kv, pv)
    assert cuda_cliquebig.quad_count(y2, core, erow[:0], c1[:0],
                                     n_bits).numel() == 0
    assert cuda_cliquebig.quad_count.launches == before + 1


@pytest.mark.parametrize("w,shift", [(5, 0), (128, 1), (32, 2)])
def test_quad_refuses_unaligned(dev, w, shift):
    """Q reads 16-byte words: a width, a row stride or a table start that
    is not 16-byte aligned makes both wrappers raise, launching nothing."""
    rng = np.random.default_rng(300 + w + shift)
    y2, core, erow, c1, off, n_bits = quad_case(rng, dev, w, n=500,
                                                shift=shift)
    before = (cuda_cliquebig.quad_count.launches,
              cuda_cliquebig.quad_emit.launches)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_cliquebig.quad_count(y2, core, erow, c1, n_bits)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_cliquebig.quad_emit(y2, core, erow, c1, off, n_bits)
    assert (cuda_cliquebig.quad_count.launches,
            cuda_cliquebig.quad_emit.launches) == before


def test_quad_emit_rounds(dev):
    """Tiles that stage in rounds: tasks of 4096 quads (every bit of a
    128-word row) at unaligned offsets, a tile with no quads, unsorted
    erow, one task of each row, then runs of equal erow."""
    rng = np.random.default_rng(7)
    w, e, c = 128, 300, 200
    y2 = words(rng, e, w) & words(rng, e, w)
    core = words(rng, c, w)
    y2[0], core[0] = -1, -1                       # 4096 quads
    y2[1] = 0                                     # none
    erow = rng.integers(0, e, 3000).astype(np.int32)
    c1 = rng.integers(0, c, 3000).astype(np.int32)
    erow[:128] = 1                                # a tile with no quads
    erow[130:160:3], c1[130:160:3] = 0, 0
    erow[1000:2000] = np.sort(erow[1000:2000])    # runs of equal erow
    erow[2500:2503], c1[2500:2503] = 0, 0
    t = lambda a: torch.from_numpy(a).to(dev)
    y2, core, erow, c1 = t(y2), t(core), t(erow), t(c1)
    counts = cuda_cliquebig.quad_count(y2, core, erow, c1, 32 * w)
    assert int(counts.max()) == 32 * w and int(counts[:128].sum()) == 0
    off = cuda_cliquebig.quad_offsets(counts) + 1
    args = (y2, core, erow, c1, off, 32 * w)
    for kv, pv in zip(cuda_cliquebig.quad_emit(*args),
                      cuda_cliquebig.quad_emit_plain(*args)):
        assert torch.equal(kv, pv)


def test_quad_kernels_one_kernel_a_call(dev):
    """A quad_count call and a quad_emit call each run their kernel and no
    other device op; each launches once a call."""
    rng = np.random.default_rng(9)
    y2, core, erow, c1, off, n_bits = quad_case(rng, dev, 128)
    n_q = int(off[-1] - off[0])
    for fn, name, key in (
            (lambda: cuda_cliquebig.quad_count(y2, core, erow, c1, n_bits),
             "quad_count", "quad_count_kernel"),
            (lambda: cuda_cliquebig.quad_emit(y2, core, erow, c1, off,
                                              n_bits, n_q),
             "quad_emit", "quad_emit_kernel")):
        wrapper = getattr(cuda_cliquebig, name)
        before = wrapper.launches
        ops = _device_ops(fn)
        assert wrapper.launches == before + 50
        assert len(ops) == 1 and 0.9 <= next(iter(ops.values())) <= 1.0, ops
        assert key in next(iter(ops)), ops


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("hw", [1, 2, 8])
def test_bit_gram_cliquebig_widths(dev, hw, depth):
    """G at the large-clique engine's hi widths (hw 8, 2 and 1 at k = 6, 7
    and 8) and depths (k - 4) == its plain version."""
    rng = np.random.default_rng(50 + 10 * hw + depth)
    base, mask, kw = gram_inputs(rng, dev, hw, depth, 30_001)
    got = cuda_gram.bit_gram(base, mask, **kw)
    assert torch.equal(got, cuda_gram.bit_gram_plain(base, mask, **kw))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("nrow", [5, 6, 7])
def test_lo_popcount_vary_last(dev, nrow):
    """L over the large-clique engine's lo run tables: nrow 5-7 (k = 6-8),
    the last column varying."""
    rng = np.random.default_rng(200 + nrow)
    v, c, w = 5000, 4096, 128
    bm_np = words(rng, v, w) | words(rng, v, w)
    lengths = rng.choice([1, 1, 2, 3, 17, 130, 700], 400)
    cols = run_tasks(rng, nrow, nrow - 1, v, c, lengths)
    bm = torch.from_numpy(bm_np).to(dev)
    runs = cuda_cliquek.lo_runs(cols, nrow - 1, device=dev)
    got = cuda_cliquek.lo_popcount(bm, bm[v - c:], runs)
    assert int(got.sum()) == int(cuda_cliquek.lo_popcount_plain(
        bm, bm[v - c:], runs).sum()) > 0


def kernel_events(fn):
    """{kernel name: launches} of our kernels that torch.profiler records
    over fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        val = fn()
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
    out = {}
    for key in ("bit_gram_kernel", "lo_popcount_kernel", "quad_emit_kernel",
                "quad_count_kernel"):
        out[key] = sum(n for name, n in names.items() if key in name)
    return val, out


@pytest.mark.parametrize("k,device_path", [(6, False), (6, True), (7, False)])
def test_cliquebig_engine_on_card(dev, k, device_path):
    """rmat12 with a small core (lo tasks and a tail) and small dispatches:
    the card's count equals the CPU's, at two dispatch sizes (the pinned
    buffers are refilled under asynchronous copies); one G launch a hi
    dispatch, one L launch a lo dispatch, one Q emit launch a chunk and one
    Q count launch a count on the device path, by the wrappers' counts and
    by torch.profiler."""
    from unittest import mock
    from graphminer_tpu_torch.ops import cliquebig
    g = rmat(12, 8, seed=23)
    kw = dict(core=512, hi=32)
    want = cliquebig.CliqueBigEngine(g, k, device="cpu", **kw).count()
    eng = cliquebig.CliqueBigEngine(g, k, device=dev, **kw)
    if device_path:
        eng.DEV6_MIN_TRIS, eng.T6, eng.CAP6 = 0, 1 << 14, 1 << 17
    else:
        eng.DEV6_MIN_TRIS = 1 << 62
    for d in (1 << 15, cliquebig.DISPATCH_TASKS):
        with mock.patch.object(cliquebig, "DISPATCH_TASKS", d):
            before = (cuda_gram.bit_gram.launches,
                      cuda_cliquek.lo_popcount.launches,
                      cuda_cliquebig.quad_emit.launches,
                      cuda_cliquebig.quad_count.launches)
            got, ev = kernel_events(eng.count)
            after = (cuda_gram.bit_gram.launches,
                     cuda_cliquek.lo_popcount.launches,
                     cuda_cliquebig.quad_emit.launches,
                     cuda_cliquebig.quad_count.launches)
        assert got == want
        assert eng.path == ("device" if device_path else "host")
        disp = eng.dispatches
        n = (disp.get("hi", 0), disp.get("lo", 0), disp.get("quad", 0),
             int(device_path))
        assert tuple(a - b for a, b in zip(after, before)) == n
        assert (ev["bit_gram_kernel"], ev["lo_popcount_kernel"],
                ev["quad_emit_kernel"], ev["quad_count_kernel"]) == n
        assert n[0] > 0 and n[1] > 0 and (n[2] > 0) == device_path


def sgl_tables(dev, seed, v=3000, w=128, max_deg=150):
    """A bitmap table with bit 31 in every row and a sorted CSR without
    repeats, with ftw in [0, deg + 2], as FtLists on `dev`."""
    rng = np.random.default_rng(seed)
    tab = words(rng, v, w)
    tab[:, 0] |= np.int32(-2**31)
    deg = rng.integers(0, max_deg + 1, v)
    rows = [np.sort(rng.choice(v, int(d), replace=False)) for d in deg]
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    colidx = np.concatenate(rows).astype(np.int32)
    ftw = rng.integers(0, deg + 3).astype(np.int32)
    ft = cuda_tri.FtLists.from_csr(rowptr, colidx, ftw, dev)
    return rng, torch.from_numpy(tab).to(dev), ft


def sgl_ids(rng, dev, lo, hi, n):
    x = rng.integers(lo, hi, n).astype(np.int32)
    x[::97] = SENTINEL
    return torch.from_numpy(x).to(dev)


def run_ids(rng, v, n, order):
    """n task ids in sorted runs of 150-300 tasks (longer than the kernels'
    windows, at most 128) or in runs of 1, with ids outside [0, v) inside
    the runs."""
    if order == "runs":
        lens = rng.integers(150, 301, n // 150 + 1)
        x = np.repeat(np.sort(rng.integers(0, v, lens.size)), lens)[:n]
    else:
        x = np.resize(np.arange(v), n)
    x = x.astype(np.int64)
    x[7::131], x[11::173], x[13::197] = -1, v, SENTINEL
    return x.astype(np.int32)


def ascending_in_runs(ids, vals):
    """vals sorted ascending inside each run of equal ids (the engine's
    order)."""
    run = np.cumsum(np.r_[True, ids[1:] != ids[:-1]])
    return vals[np.lexsort((vals, run))]


def sgl_order(rng, dev, order, lo, hi, v, n, vals=None):
    """(ids, per-task values) on `dev`: random ids in [lo, hi) with values
    from sgl_ids, or run_ids with `vals` ascending in each run."""
    if order == "random":
        return sgl_ids(rng, dev, lo, hi, n), None
    ids = run_ids(rng, v, n, order)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(
        ascending_in_runs(ids, vals).astype(np.int32)).to(dev)


@pytest.mark.parametrize("order", ["random", "runs", "runs_of_1"])
@pytest.mark.parametrize("w", [8, 32, 128, 160])
def test_tri_bitmap(dev, w, order):
    """Random ids (runs of ~1), sorted runs longer than a window and runs
    of 1; 160 words take the kernel's uncached loop."""
    rng, tab, _ = sgl_tables(dev, w, w=w, max_deg=4)
    v = tab.shape[0]
    src, dst = sgl_order(rng, dev, order, -3, v + 3, v, 50001,
                         rng.integers(-3, v + 3, 50001))
    if dst is None:
        dst = sgl_ids(rng, dev, 0, v, 50001)
    n0 = cuda_tri.tri_bitmap.launches
    got = cuda_tri.tri_bitmap(tab, src, dst)
    assert cuda_tri.tri_bitmap.launches == n0 + 1
    assert torch.equal(got, cuda_tri.tri_bitmap_plain(tab, src, dst))


def edge_vloc(rng, w, n):
    """Bits at sector and word edges (31/32, 255/256), the last bit, just
    outside [0, 32 w), and random."""
    edges = np.array([b for b in (0, 31, 32, 255, 256, 32 * w - 1, -1,
                                  32 * w) if b <= 32 * w])
    vl = rng.integers(0, 32 * w, n)
    vl[::3] = rng.choice(edges, vl[::3].size)
    return vl


@pytest.mark.parametrize("order", ["random", "runs", "runs_of_1"])
@pytest.mark.parametrize("w", [8, 12, 128])
def test_tri_probe(dev, w, order):
    """Random tasks, sorted runs longer than a warp's 32 tasks and runs of
    1, with bits at sector edges and bit 31 of every word; lists up to 152
    slots; 12 words end on half a 32-byte sector."""
    rng, tab, ft = sgl_tables(dev, 10 + w, w=w)
    v = tab.shape[0]
    tab |= -2**31
    u, vloc = sgl_order(rng, dev, order, -2, v + 2, v, 40000,
                        edge_vloc(rng, w, 40000))
    if vloc is None:
        vloc = sgl_ids(rng, dev, -2, 32 * w + 2, 40000)
        vloc[:500] = 31
    n0 = cuda_tri.tri_probe.launches
    got = cuda_tri.tri_probe(ft, tab, u, vloc)
    assert cuda_tri.tri_probe.launches == n0 + 1
    want = cuda_tri.tri_probe_plain(ft, tab, u, vloc)
    assert torch.equal(got, want) and want[(vloc & 31) == 31].any()


def test_tri_probe_unaligned_table(dev):
    """A 13-word table that starts 4 bytes past a 16-byte edge."""
    rng, tab, ft = sgl_tables(dev, 3, w=13)
    v = tab.shape[0]
    flat = torch.empty(v * 13 + 1, dtype=torch.int32, device=dev)
    ut = flat[1:].view(v, 13)
    ut.copy_(tab)
    assert ut.data_ptr() % 16
    u, vloc = sgl_order(rng, dev, "runs", -2, v + 2, v, 40000,
                        edge_vloc(rng, 13, 40000))
    n0 = cuda_tri.tri_probe.launches
    got = cuda_tri.tri_probe(ft, ut, u, vloc)
    assert cuda_tri.tri_probe.launches == n0 + 1
    want = cuda_tri.tri_probe_plain(ft, tab, u, vloc)
    assert torch.equal(got, want) and want.any()


@pytest.mark.parametrize("max_deg", [150, 1200])
@pytest.mark.parametrize("order", ["random", "runs", "runs_of_1"])
def test_tri_lists(dev, order, max_deg):
    """Random tasks, sorted runs longer than a window and runs of 1, with
    ids outside [0, V) inside the runs; lists up to 152 ids, or up to 1202
    (searches of 11 steps, shorter lists of many rounds)."""
    rng, _, ft = sgl_tables(dev, 5 + max_deg, max_deg=max_deg)
    v = ft.n_vertices
    u, w = sgl_order(rng, dev, order, -2, v + 2, v, 40000,
                     rng.integers(-2, v + 2, 40000))
    if w is None:
        w = sgl_ids(rng, dev, 0, v, 40000)
    assert max_deg < 1000 or int(ft.lengths(u)[1].max()) > 1000
    n0 = cuda_tri.tri_lists.launches
    got = cuda_tri.tri_lists(ft, u, w)
    assert cuda_tri.tri_lists.launches == n0 + 1
    assert torch.equal(got, cuda_tri.tri_lists_plain(ft, u, w))
    assert got.any()


@pytest.mark.parametrize("w", [8, 40, 128, 300])
def test_bit_colsum(dev, w):
    rng, tab, ft = sgl_tables(dev, 20 + w, w=w, max_deg=60)
    u = sgl_ids(rng, dev, -2, tab.shape[0] + 2, 700)
    n0 = cuda_colsum.bit_colsum.launches
    got = cuda_colsum.bit_colsum(ft, tab, u)
    assert cuda_colsum.bit_colsum.launches == n0 + 1
    assert torch.equal(got, cuda_colsum.bit_colsum_plain(ft, tab, u))
    assert got[:, 31].any()


def pairs_plan(dev, seed, v=3000, w=128, max_deg=150, cut=1024):
    """A random table (bit 31 in every row), a CSR with ids outside [0, v)
    and rows of degree 0 and 1, and its PairsPlan over every row and a few
    bad ids, on `dev`."""
    rng = np.random.default_rng(seed)
    tab = words(rng, v, w)
    tab[:, -1] |= np.int32(-2**31)
    deg = rng.integers(0, max_deg + 1, v)
    deg[:4] = [0, 1, 0, 1]
    deg[4] = 3000
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    colidx = rng.integers(-2, v + 2, int(deg.sum())).astype(np.int32)
    u = np.concatenate([np.arange(v), [-1, v]]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    plan = cuda_colsum.plan_pairs(t(rowptr), t(colidx), t(u), v // 2,
                                  32 * w - 5, cut)
    return torch.from_numpy(tab).to(dev), plan


@pytest.mark.parametrize("w,cut", [(8, 1024), (40, 64), (128, 1024),
                                   (128, 100), (256, 4096)])
def test_colsum_pairs(dev, w, cut):
    """W's pairs mode == its plain version, with and without split rows;
    the finish launches only when the plan splits a row."""
    tab, plan = pairs_plan(dev, w + cut, w=w, cut=cut)
    n0 = (cuda_colsum.colsum_pairs.launches,
          cuda_colsum.colsum_finish.launches)
    total, counts = cuda_colsum.colsum_pairs(plan, tab)
    want_t, want_c = cuda_colsum.colsum_pairs_plain(plan, tab)
    assert torch.equal(total, want_t) and torch.equal(counts, want_c)
    split = plan.long_u.numel() > 0
    assert split == (cut < 3000)
    if split:
        got = cuda_colsum.colsum_finish(plan, counts, total.clone())
        assert torch.equal(got, cuda_colsum.colsum_finish_plain(
            plan, want_c, want_t))
    assert (cuda_colsum.colsum_pairs.launches - n0[0],
            cuda_colsum.colsum_finish.launches - n0[1]) == (1, int(split))
    assert int(total) > 0 and (counts.any() or not split)


def test_sgl_kernels_launch_nothing_without_tasks(dev):
    _, tab, ft = sgl_tables(dev, 1)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    before = (cuda_tri.tri_bitmap.launches, cuda_tri.tri_probe.launches,
              cuda_tri.tri_lists.launches, cuda_colsum.bit_colsum.launches)
    assert cuda_tri.tri_bitmap(tab, e, e).numel() == 0
    assert cuda_tri.tri_probe(ft, tab, e, e).numel() == 0
    assert cuda_tri.tri_lists(ft, e, e).numel() == 0
    assert cuda_colsum.bit_colsum(ft, tab, e).numel() == 0
    assert (cuda_tri.tri_bitmap.launches, cuda_tri.tri_probe.launches,
            cuda_tri.tri_lists.launches,
            cuda_colsum.bit_colsum.launches) == before
    plan = cuda_colsum.plan_pairs(ft.rowptr, ft.colidx, e, 10, 100)
    p0 = (cuda_colsum.colsum_pairs.launches,
          cuda_colsum.colsum_finish.launches)
    assert cuda_colsum.pairs_count(plan, tab) == 0
    assert (cuda_colsum.colsum_pairs.launches,
            cuda_colsum.colsum_finish.launches) == p0


@pytest.mark.parametrize("core", [256, 4096])
def test_tri_support_on_card(dev, core):
    """rmat12: tri on the card equals the CPU's; one launch each of S and,
    when the core leaves sub-core ends, P and I; the diamond count
    equals the CPU's."""
    g = rmat(12, 16, seed=7)
    launches = lambda: (cuda_tri.tri_bitmap.launches,
                        cuda_tri.tri_probe.launches,
                        cuda_tri.tri_lists.launches)
    before = launches()
    ts = tri_support.tri_support(g, core=core, device=dev)
    got = tuple(a - b for a, b in zip(launches(), before))
    ref = tri_support.tri_support(g, core=core, device="cpu")
    assert torch.equal(ts.tri.cpu(), ref.tri)
    assert got == ((1, 1, 1) if core < 4096 else (1, 0, 0))
    assert tri_support.diamond_count_fast(g, core=core, device=dev) == \
        tri_support.pairs_sum(ref.tri)


def test_rectangle_on_card(dev, monkeypatch):
    """rmat12 at core 256: the card's count equals the CPU's and the
    golden; level 0 is one launch of W's pairs mode and, when a row is
    longer than the segment cut (rmat12's longest has 1344 slots), one
    finish launch, and the engine launches no W write mode, no X and no
    torch._int_mm."""
    g = rmat(12, 16, seed=7)
    int_mm = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda *a: int_mm.append(1) or real(*a))
    launches = lambda: (cuda_colsum.colsum_pairs.launches,
                        cuda_colsum.colsum_finish.launches,
                        cuda_colsum.bit_colsum.launches,
                        cuda_expand.expand_bits.launches)
    for chunk, finish in ((1024, 1), (4096, 0)):
        before = launches()
        got = rectangle.rectangle_count_fast(g, core=256, chunk=chunk,
                                             device=dev)
        assert tuple(a - b for a, b in zip(launches(), before)) == \
            (1, finish, 0, 0)
        assert got == 52_988_519
    assert not int_mm
    assert rectangle.rectangle_count_fast(g, core=256, device="cpu") == \
        52_988_519


def house_tables(dev, seed, v=3000, w=128, max_deg=150, n_long=20):
    """A bitmap table with bit 31 in every row and a CSR whose rows hold
    ids outside [0, v) (and SENTINEL) and n_long rows of 1,100-3,000 slots
    (longer than a segment), ftw in [-1, deg + 2] with some lists empty,
    as FtLists on `dev`."""
    rng = np.random.default_rng(seed)
    tab = words(rng, v, w)
    tab[:, -1] |= np.int32(-2**31)
    deg = rng.integers(0, max_deg + 1, v)
    deg[rng.choice(v, n_long, replace=False)] = rng.integers(1100, 3000,
                                                             n_long)
    colidx = rng.integers(-2, v + 2, int(deg.sum())).astype(np.int32)
    colidx[::97] = SENTINEL
    ftw = rng.integers(-1, deg + 3).astype(np.int32)
    ftw[::13] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    ft = cuda_tri.FtLists.from_csr(rowptr, colidx, ftw, dev)
    return rng, torch.from_numpy(tab).to(dev), ft


@pytest.mark.parametrize("order", ["random", "runs", "runs_of_1", "long"])
@pytest.mark.parametrize("w", [8, 12, 128, 160])
def test_house_t3(dev, w, order):
    """H == its plain version, one launch a call: random tasks, sorted runs
    longer than a window, runs of 1, and runs of 3,000 tasks (longer than a
    piece) over lists up to 3,000 ids (longer than a segment); 12 words
    leave lanes idle, 160 take two column stretches."""
    rng, tab, ft = house_tables(dev, w + len(order), w=w)
    v = tab.shape[0]
    n = 40000
    if order == "long":
        a = np.repeat(rng.integers(0, v, n // 3000 + 1), 3000)[:n]
        a = torch.from_numpy(a.astype(np.int32)).to(dev)
    else:
        a, _ = sgl_order(rng, dev, order, -2, v + 2, v, n, np.zeros(n))
    b = sgl_ids(rng, dev, -2, v + 2, n)
    n0 = cuda_house.house_t3.launches
    got = cuda_house.house_t3(ft, tab, a, b)
    assert cuda_house.house_t3.launches == n0 + 1
    assert torch.equal(got, cuda_house.house_t3_plain(ft, tab, a, b))
    assert got.any()


def test_house_t3_launches_nothing_without_work(dev):
    """No task, or no task with a list: no launch, zeros."""
    _, tab, ft = house_tables(dev, 2, n_long=0)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    ids = torch.arange(-2, ft.n_vertices + 2, dtype=torch.int32, device=dev)
    empty = cuda_tri.FtLists(rowptr=ft.rowptr, colidx=ft.colidx,
                             ftw=torch.zeros_like(ft.ftw))
    n0 = cuda_house.house_t3.launches
    assert cuda_house.house_t3(ft, tab, e, e).numel() == 0
    assert not cuda_house.house_t3(empty, tab, ids, ids).any()
    assert cuda_house.house_t3.launches == n0


@pytest.mark.parametrize("order", ["runs", "long", "runs_of_1"])
def test_house_t3_view_and_plans(dev, order):
    """A graph-like table (sorted rows, the core table of their suffixes):
    H with the sparse view and without it, over a plan built before the
    call and over the wrapper's own, and over plans of block items alone
    and of warp items alone, == plain; one launch a call."""
    rng = np.random.default_rng(len(order))
    v, c = 6000, 1024
    cs = v - c
    rows = [np.unique(np.concatenate([rng.integers(0, v, d),
                                      rng.integers(cs, v, d)]))
            for d in rng.integers(0, 200, v)]
    for x in rng.choice(v, 4, replace=False):
        rows[x] = np.unique(rng.integers(0, v, 5000))
    rowptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    colidx = np.concatenate(rows).astype(np.int32)
    src = np.repeat(np.arange(v), np.diff(rowptr))
    core = colidx >= cs
    tab = np.zeros((v, c // 32), dtype=np.uint32)
    cc = colidx[core].astype(np.int64) - cs
    np.bitwise_or.at(tab, (src[core], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    nbc = np.bincount(src[core], minlength=v).astype(np.int32)
    deg = np.diff(rowptr)
    ftw = np.where(rng.random(v) < 0.5, deg, rng.integers(0, deg + 2))
    n = 60000
    if order == "long":
        a = np.repeat(np.argsort(-deg)[:10], n // 10)
    elif order == "runs":
        a = np.sort(rng.integers(0, v, n))
    else:
        a = np.resize(np.arange(v), n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.int32)).to(dev)
    ft = cuda_tri.FtLists.from_csr(rowptr, colidx, ftw, dev)
    args = (ft, t(tab.view(np.int32)), t(a), t(rng.integers(0, v, n)))
    view = cuda_house.HouseView(nbc=t(nbc), cs=cs)
    plan = cuda_house.plan_house(*args[:3], view)
    want = cuda_house.house_t3_plain(*args)
    n0 = cuda_house.house_t3.launches
    for kw in (dict(view=view, plan=plan), dict(view=view), dict(plan=plan),
               {}):
        assert torch.equal(cuda_house.house_t3(*args, **kw), want)
    assert cuda_house.house_t3.launches == n0 + 4
    entry = cuda_house._build.entry("gm_house_t3")
    for sparse in (-1, 1 << 20):
        one = cuda_house.plan_house(*args[:3], view, sparse=sparse)
        for v_ in (view, None):
            assert torch.equal(cuda_house.launch(entry, *args, v_, one), want)
    assert want.any()


@pytest.mark.parametrize("core", [64, 4096])
def test_house_on_card(dev, core):
    """rmat(10, 8, seed=5): T3 and the house count on the card equal the
    CPU's; two launches of H a count (one when the core holds every
    vertex)."""
    g = rmat(10, 8, seed=5)
    n0 = cuda_house.house_t3.launches
    _, _, _, t3 = house.edge_t3(g, core=core, device=dev)
    assert cuda_house.house_t3.launches - n0 == (2 if core < 1024 else 1)
    assert torch.equal(t3.cpu(), house.edge_t3(g, core=core,
                                               device="cpu")[3])
    assert house.house_count_fast(g, core=core, device=dev) == \
        house.house_count_fast(g, core=core, device="cpu") > 0


def labelled_rmat10():
    g = rmat(10, 8, seed=7)
    g.vlabels = np.random.default_rng(7).integers(
        1, 5, g.n_vertices).astype(np.uint8)
    return g


def our_launches():
    return sum(f.launches for f in (
        cuda_stream.stream_bucket_count, cuda_ring.ring_phase_c,
        cuda_ring.ring_tail_pairs, cuda_hubcore.hub_tail_count,
        cuda_expand.expand_bits, cuda_cliquek.lo_popcount,
        cuda_gram.bit_gram, cuda_cliquebig.quad_emit,
        cuda_cliquebig.quad_count, cuda_tri.tri_bitmap, cuda_tri.tri_probe,
        cuda_tri.tri_lists, cuda_colsum.bit_colsum, cuda_colsum.colsum_pairs,
        cuda_colsum.colsum_finish, cuda_house.house_t3))


@pytest.mark.parametrize("minsup,want", [(30, 50), (100, 36)])
def test_fsm_on_card(dev, minsup, want):
    """Labelled rmat10, k = 2: the count and every evaluated pattern's MNI
    support on the card equal the CPU's; no kernel of ours launched."""
    g = labelled_rmat10()
    n0 = our_launches()
    card = fsm._FSM(g, minsup, device=dev)
    assert card.run(2) == want
    assert our_launches() == n0
    cpu = fsm._FSM(g, minsup, device="cpu")
    assert cpu.run(2) == want
    assert card.supports == cpu.supports


def test_fsm_edge_labels_on_card(dev):
    from graphminer_tpu_torch.io.synth import labeled_er
    g = labeled_er(300, 0.03, n_vlabels=3, n_elabels=2, seed=4)
    card = fsm._FSM(g, 5, device=dev)
    cpu = fsm._FSM(g, 5, device="cpu")
    assert card.run(3) == cpu.run(3) > 0
    assert card.supports == cpu.supports


def test_query_on_card(dev):
    g = labelled_rmat10()
    q = query.make_query([(0, 1), (1, 2), (0, 2), (2, 3)], [1, 2, 3, 4])
    n0 = our_launches()
    got = query.query_count(g, q, device=dev)
    assert got == query.query_count(g, q, use_filter=False, device=dev)
    assert our_launches() == n0
    assert got == query.query_count(g, q, device="cpu") > 0


@pytest.mark.parametrize("k,kw", [(3, (1, 2, 3)), (3, (1, 2))])
def test_gks_on_card(dev, k, kw):
    g = labelled_rmat10()
    n0 = our_launches()
    got = keyword.gks_count(g, k, kw, device=dev)
    assert our_launches() == n0
    assert got == keyword.gks_count(g, k, kw, device="cpu") > 0
