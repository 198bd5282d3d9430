"""Kernels A-E, m3, m3b, R, X and L against their plain PyTorch versions
on a CUDA card, A, B, C and E also as one grouped launch over many buckets.

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
from graphminer_tpu_torch.ops import (cuda_check, cuda_cliquek,
                                      cuda_expand, cuda_hubcore, cuda_ring,
                                      cuda_stream, cuda_window, fetch)
from graphminer_tpu_torch.ops.hubcore import TriangleEngine
from graphminer_tpu_torch.ops.ring import RingEngine
from graphminer_tpu_torch.ops.stream import StreamEngine

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
    rng = np.random.default_rng(nrow * words_)
    v, c, n = 3000, 900, 20000
    bm = torch.from_numpy(words(rng, v, words_)).to(dev)
    core = bm[v - c:]
    cols = np.concatenate([rng.integers(-1, v + 1, (n, 2)),
                           rng.integers(-2, c + 2, (n, nrow - 2))], axis=1
                          ).astype(np.int32)
    cols[-100:] = SENTINEL
    cols = torch.from_numpy(cols).to(dev)
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(bm, core, cols)
    assert cuda_cliquek.lo_popcount.launches == before + 1
    assert int(got.sum()) == int(cuda_cliquek.lo_popcount_plain(
        bm, core, cols).sum()) > 0


def test_lo_popcount_no_tasks(dev):
    bm = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(
        bm, bm[32:], torch.zeros((0, 4), dtype=torch.int32, device=dev))
    assert cuda_cliquek.lo_popcount.launches == before
    assert int(got.sum()) == 0


@pytest.mark.parametrize("k", [4, 5])
def test_cliquek_engine_on_card(dev, k):
    """rmat12 with a small core: a real lo population and tail; the card's
    count equals the CPU's, with L launched once and X once a slab."""
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    g = rmat(12, 8, seed=23)
    eng = CliqueKEngine(g, k, core=256, hi=64, slab=4096, device=dev)
    want = CliqueKEngine(g, k, core=256, hi=64, device="cpu").count()
    assert eng.n_lo > 0 and eng.n_slabs > 1
    x, lo = cuda_expand.expand_bits.launches, cuda_cliquek.lo_popcount.launches
    assert eng.count() == want
    assert (cuda_expand.expand_bits.launches - x,
            cuda_cliquek.lo_popcount.launches - lo) == (eng.n_slabs, 1)


def test_hub_core_spoke_on_x(dev):
    """The hub-core count with the spoke expanded by X: one X launch a slab
    and one for the core mask."""
    g = rmat(12, 16, seed=7)
    eng = TriangleEngine(g, core=1024, device=dev)
    before = cuda_expand.expand_bits.launches
    assert eng.count() == 482_181
    assert cuda_expand.expand_bits.launches > before
    assert eng.count_core() == \
        TriangleEngine(g, core=1024, device="cpu").count_core()
