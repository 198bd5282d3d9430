"""The plain PyTorch versions of kernels S, P, I (ops/cuda_tri.py), W
(ops/cuda_colsum.py) and H (ops/cuda_house.py) against the JAX package's
expressions they replace (graphminer_tpu/ops/tri_support.py::_bitmap_tri,
::_subcore_bit_probe, ::_list_intersect, the wsub sum of
ops/rectangle.py::_case_b and ops/house.py::_t3_edges) or numpy
definitions on random inputs from numpy seeds: words with bit 31 set, lists read in place from a
sorted CSR (JAX gets them gathered and SENTINEL padded), ids outside the
table, SENTINEL, and empty inputs. All exact. The kernels themselves run
only on a card (tests/test_torch_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.ops import tri_support as jts
from graphminer_tpu.ops.hubcore import _expand_bits as jexpand
from graphminer_tpu_torch.ops import cuda_colsum, cuda_tri
from graphminer_tpu_torch.ops.cuda_tri import FtLists
from graphminer_tpu_torch.workloads.sgl import sgl_count

SENTINEL = np.iinfo(np.int32).max


def words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def random_csr(rng, v, max_deg):
    """Sorted rows without repeats (ids in [0, v)) and ftw in [0, deg + 2]
    (a length past the row is cut to the row)."""
    deg = rng.integers(0, max_deg + 1, v)
    rows = [np.sort(rng.choice(v, min(int(d), v), replace=False))
            for d in deg]
    rowptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    colidx = np.concatenate(rows + [np.zeros(0, np.int64)]).astype(np.int32)
    ftw = rng.integers(0, deg + 3).astype(np.int32)
    return rowptr.astype(np.int64), colidx, ftw


def jax_lists(rowptr, colidx, ftw, ids, width):
    """FT(x) of each id gathered and SENTINEL padded, as JAX takes them."""
    out = np.full((ids.size, max(width, 1)), SENTINEL, dtype=np.int32)
    for i, x in enumerate(ids):
        if 0 <= x < ftw.size:
            n = min(int(ftw[x]), int(rowptr[x + 1] - rowptr[x]))
            out[i, :n] = colidx[rowptr[x]:rowptr[x] + n]
    return out


def fixture(seed, v=200, w=8, max_deg=40):
    rng = np.random.default_rng(seed)
    tab = words(rng, v, w)
    tab[:, 0] |= np.int32(-2**31)                 # bit 31 in every row
    rowptr, colidx, ftw = random_csr(rng, v, max_deg)
    return rng, tab, rowptr, colidx, ftw, FtLists.from_csr(
        rowptr, colidx, ftw, "cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@pytest.mark.parametrize("w", [8, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_tri_bitmap_plain_equals_jax(seed, w):
    rng = np.random.default_rng(seed)
    v, n = 300, 2000
    tab = words(rng, v, w)
    src = rng.integers(-5, v + 5, n).astype(np.int32)
    dst = rng.integers(0, v, n).astype(np.int32)
    src[:7] = SENTINEL
    want = np.asarray(jts._bitmap_tri(jnp.asarray(tab), jnp.asarray(src),
                                      jnp.asarray(dst), words=w,
                                      chunk=512))[:n]
    got = cuda_tri.tri_bitmap(t(tab), t(src), t(dst))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[:7].eq(0).all()


def test_tri_bitmap_bit31():
    tab = np.zeros((4, 8), np.int32)
    tab[1, 3] = tab[2, 3] = np.int32(-2**31)        # core-local id 127
    tab[1, 5] = tab[2, 5] = -1
    got = cuda_tri.tri_bitmap(t(tab), t([1, 1]), t([2, 0]))
    assert got.tolist() == [33, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tri_probe_plain_equals_jax(seed):
    rng, tab, rowptr, colidx, ftw, ft = fixture(seed)
    v, w = tab.shape
    n = 500
    u = rng.integers(0, v, n).astype(np.int32)
    vloc = rng.integers(0, 32 * w, n).astype(np.int32)
    vloc[:20] = 31 + 32 * rng.integers(0, w, 20)   # bit 31 of a word
    wa = int(max(1, min(ftw.max(), np.diff(rowptr).max())))
    lists = jax_lists(rowptr, colidx, ftw, u, wa)
    want = np.asarray(jts._subcore_bit_probe(
        jnp.asarray(tab.reshape(-1)), jnp.asarray(lists), jnp.asarray(vloc),
        wa=wa, words=w, chunk=128))[:n]
    got = cuda_tri.tri_probe(ft, t(tab), t(u), t(vloc))
    assert np.array_equal(got.numpy(), want)
    assert want[:20].any()


def test_tri_probe_out_of_range_adds_zero():
    _, tab, rowptr, colidx, ftw, ft = fixture(3)
    v, w = tab.shape
    ok = int(np.argmax(np.minimum(ftw, np.diff(rowptr))))
    u = t([SENTINEL, -1, v, ok, ok, ok])
    vloc = t([0, 0, 0, -1, 32 * w, 32 * w + 31])
    assert cuda_tri.tri_probe(ft, t(tab), u, vloc).tolist() == [0] * 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tri_lists_plain_equals_jax(seed):
    rng, tab, rowptr, colidx, ftw, ft = fixture(seed, v=120, max_deg=60)
    v = ftw.size
    n = 400
    u = rng.integers(0, v, n).astype(np.int32)
    w = rng.integers(0, v, n).astype(np.int32)
    u[:5] = SENTINEL                               # empty list
    w[5:10] = v + 3
    wa = int(max(1, min(ftw.max(), np.diff(rowptr).max())))
    want = np.asarray(jts._list_intersect(
        jnp.asarray(jax_lists(rowptr, colidx, ftw, u, wa)),
        jnp.asarray(jax_lists(rowptr, colidx, ftw, w, wa)),
        wa=wa, wb=wa, chunk=64))[:n]
    got = cuda_tri.tri_lists(ft, t(u), t(w))
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not got[:10].any()


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_bit_colsum_plain_equals_jax(seed, w):
    """W against the wsub expression of JAX's _case_b: gathered rows,
    int8 expansion, a sum over the list axis."""
    rng, tab, rowptr, colidx, ftw, ft = fixture(seed, w=w)
    v = ftw.size
    u = rng.integers(0, v, 64).astype(np.int32)
    u[:3] = [SENTINEL, -1, v]
    wa = int(max(1, min(ftw.max(), np.diff(rowptr).max())))
    lists = jax_lists(rowptr, colidx, ftw, u, wa)
    ok = lists != SENTINEL
    rows = jnp.where(jnp.asarray(ok)[:, :, None],
                     jnp.asarray(tab)[jnp.asarray(np.where(ok, lists, 0))], 0)
    bits = jexpand(rows.reshape(-1, w), 32 * w, dtype=jnp.int8)
    want = np.asarray(jnp.sum(bits.reshape(u.size, wa, 32 * w), axis=1,
                              dtype=jnp.int32))
    got = cuda_colsum.bit_colsum(ft, t(tab), t(u))
    assert got.dtype == torch.int32 and got.shape == (u.size, 32 * w)
    assert np.array_equal(got.numpy(), want)
    assert not got[:3].any() and got[:, 31].any()     # bit 31 counts


def test_empty_inputs():
    _, tab, rowptr, colidx, ftw, ft = fixture(0)
    e = t(np.zeros(0, np.int32))
    assert cuda_tri.tri_bitmap(t(tab), e, e).shape == (0,)
    assert cuda_tri.tri_probe(ft, t(tab), e, e).shape == (0,)
    assert cuda_tri.tri_lists(ft, e, e).shape == (0,)
    assert cuda_colsum.bit_colsum(ft, t(tab), e).shape == (0, 32 * 8)
    # every list empty
    ft0 = FtLists.from_csr(rowptr, colidx, np.zeros_like(ftw), "cpu")
    ids = t(np.arange(ftw.size))
    assert not cuda_tri.tri_lists(ft0, ids, ids).any()
    assert not cuda_colsum.bit_colsum(ft0, t(tab), ids).any()


def test_wrappers_refuse_bad_arguments():
    _, tab, rowptr, colidx, ftw, ft = fixture(0)
    with pytest.raises(TypeError):
        cuda_tri.tri_bitmap(t(tab), t([0]).long(), t([0]))
    with pytest.raises(ValueError):
        cuda_tri.tri_lists(ft, t([0, 1]), t([0]))
    bad = FtLists(rowptr=ft.rowptr.int(), colidx=ft.colidx, ftw=ft.ftw)
    with pytest.raises(TypeError):
        cuda_tri.tri_lists(bad, t([0]), t([0]))


def test_fast_house_still_exits_naming_roadmap():
    """sgl house --fast no longer exits: it runs the house engine
    (ops/house.py), which agrees with the generic plan."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.workloads.sgl import FAST_ENGINES
    g = rmat(7, 8, seed=1)
    assert FAST_ENGINES == {}
    assert sgl_count(g, "house", fast=True, device="cpu") == \
        sgl_count(g, "house", device="cpu") > 0


# --- S and P on the task orders their windows meet -------------------------
#
# tri_support hands S and P their tasks in DAG CSR order: runs of equal src
# (u), dst (vl) ascending in a run. S keeps a run's src row between the
# tasks of a window, P's lanes share a run's list and sectors within a warp
# of 32 tasks, so the cases below give runs longer than the largest window,
# runs of 1, no order at all, runs across window edges, ids outside [0, V)
# inside runs, bits on both sides of a sector edge and bit 31 of every
# word.

#: S's windows (cuda_tri.S_WINDOW and the variants measured beside it)
WINDOWS = (32, 64, 128)
ORDERS = ("long_runs", "runs_of_1", "unsorted", "window_edges")
N_ORDER = 1500


def ordered_ids(rng, order, v, n=N_ORDER):
    """n task ids in [0, v) in `order`, with ids outside [0, v) inside the
    runs."""
    if order == "unsorted":
        x = rng.integers(0, v, n)
    elif order == "runs_of_1":
        x = np.sort(rng.choice(v, min(n, v), replace=False))
        x = np.resize(x, n)                      # ascending, then again
    else:
        lens = (rng.integers(150, 301, n) if order == "long_runs" else
                np.resize([29, 37, 61, 5, 100, 1, 127, 3], n))
        ids = np.sort(rng.integers(0, v, lens.size))
        x = np.repeat(ids, lens)[:n]
    x = x.astype(np.int64)
    x[7::131] = -1
    x[11::173] = v
    x[13::197] = SENTINEL
    return x.astype(np.int32)


def within_runs(rng, ids, values, order):
    """values re-sorted ascending inside each run of equal ids (the
    engine's order), left as they are for the unsorted order."""
    if order == "unsorted":
        return values
    key = np.lexsort((values, np.cumsum(np.r_[True, ids[1:] != ids[:-1]])))
    return values[key]


def edge_bits(rng, words, n):
    """Bit indices in [0, 32 words): sector and word edges (31/32, 255/256),
    the last bit, and random ones."""
    edges = [b for b in (0, 31, 32, 255, 256, 32 * words - 1)
             if b < 32 * words]
    vl = rng.integers(0, 32 * words, n)
    vl[::3] = rng.choice(edges, vl[::3].size)
    return vl.astype(np.int32)


def bit31_table(rng, v, w):
    tab = words(rng, v, w)
    tab |= np.int32(-2**31)                        # bit 31 of every word
    return tab


def model_bitmap(tab, src, dst, window):
    """Kernel S's walk (csrc/tri_support.cu::tri_bitmap_kernel) in numpy:
    the window's quarters one after another, each keeping the row of the
    last src it loaded (rows of at most 128 words; wider rows are read a
    task). Returns (out, src rows loaded)."""
    v, w = tab.shape
    tu = tab.view(np.uint32)
    n, seg = src.size, window // 4
    out = np.zeros(n, np.int32)
    loads = 0
    for s0 in range(0, n, seg):
        cur, row = -1, None
        for t in range(s0, min(s0 + seg, n)):
            a, b = int(src[t]), int(dst[t])
            if not (0 <= a < v and 0 <= b < v):
                continue
            if w > cuda_tri.S_CACHED_WORDS or a != cur:
                cur, row = a, tu[a]
                loads += 1
            out[t] = sum(bin(int(x)).count("1") for x in row & tu[b])
    return out, loads


def model_probe(rowptr, colidx, ftw, tab, u, vl):
    """Kernel P's walk (csrc/tri_support.cu::tri_probe_kernel) in numpy:
    32 tasks a warp, a lane each; at step i every lane whose task has a bit
    in [0, 32 words) and a list longer than i probes its slot i. Counts,
    as probe_loads names them, the lists the warp's runs of equal u read
    and, per step and run, the distinct 32-byte sectors of the slot's row
    that the run's bits fall in (one request each). Returns (out,
    counts)."""
    v, w = tab.shape
    tu = tab.view(np.uint32)
    n = u.size
    out = np.zeros(n, np.int32)
    got = dict(lists=0, list_ids=0, sectors=0, probes=0)
    run = np.cumsum(np.r_[True, u[1:] != u[:-1]] | (np.arange(n) % 32 == 0))
    for w0 in range(0, n, 32):
        lists = {}
        for t in range(w0, min(w0 + 32, n)):
            a, b = int(u[t]), int(vl[t])
            if 0 <= a < v and 0 <= b < 32 * w:
                ln = min(int(ftw[a]), int(rowptr[a + 1] - rowptr[a]))
                if ln > 0:
                    lists[t] = colidx[rowptr[a]:rowptr[a] + ln]
        read = {run[t]: x.size for t, x in lists.items()}
        got["lists"] += len(read)
        got["list_ids"] += sum(read.values())
        for i in range(max((x.size for x in lists.values()), default=0)):
            requests = set()
            for t, lst in lists.items():
                x = int(lst[i]) if i < lst.size else -1
                if 0 <= x < v:
                    wi = int(vl[t]) >> 5
                    out[t] += (tu[x, wi] >> (int(vl[t]) & 31)) & 1
                    requests.add((run[t], x, wi // cuda_tri.SECTOR_WORDS))
                    got["probes"] += 1
            got["sectors"] += len(requests)
    return out, got


@pytest.mark.parametrize("w", [8, 32, 128, 160])
@pytest.mark.parametrize("order", ORDERS)
def test_tri_bitmap_orders(order, w):
    """S's plain version against JAX's _bitmap_tri on each task order, the
    numpy model of the kernel's windows against both, and bitmap_loads
    against the rows the model loads, at each window."""
    rng = np.random.default_rng(100 * ORDERS.index(order) + w)
    v = 400
    tab = bit31_table(rng, v, w)
    src = ordered_ids(rng, order, v)
    dst = within_runs(rng, src, rng.integers(-3, v + 3, src.size)
                      .astype(np.int32), order)
    want = np.asarray(jts._bitmap_tri(jnp.asarray(tab), jnp.asarray(src),
                                      jnp.asarray(dst), words=w,
                                      chunk=512))[:src.size]
    got = cuda_tri.tri_bitmap_plain(t(tab), t(src), t(dst))
    assert np.array_equal(got.numpy(), want) and want.any()
    for window in WINDOWS:
        out, loads = model_bitmap(tab, src, dst, window)
        assert np.array_equal(out, want)
        assert cuda_tri.bitmap_loads(t(tab), t(src), t(dst), window)[
            "src_rows"] == loads
    runs = cuda_tri.bitmap_loads(t(tab), t(src), t(dst))["runs"]
    assert runs == 1 + int((src[1:] != src[:-1]).sum())


@pytest.mark.parametrize("w", [16, 12])
@pytest.mark.parametrize("order", ORDERS)
def test_tri_probe_orders(order, w):
    """P's plain version against JAX's _subcore_bit_probe on each task
    order (lists past 32 slots, bits at sector edges and bit 31 of every
    word; 12 words end on half a sector), the numpy model of the kernel's
    warps against both, and probe_loads against what the model counts."""
    rng = np.random.default_rng(5000 + 100 * ORDERS.index(order) + w)
    v = 300
    tab = bit31_table(rng, v, w)
    rowptr, colidx, ftw = random_csr(rng, v, 200)
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    u = ordered_ids(rng, order, v)
    vl = within_runs(rng, u, edge_bits(rng, w, u.size), order)
    wa = int(max(1, min(ftw.max(), np.diff(rowptr).max())))
    want = np.asarray(jts._subcore_bit_probe(
        jnp.asarray(tab.reshape(-1)),
        jnp.asarray(jax_lists(rowptr, colidx, ftw, u, wa)), jnp.asarray(vl),
        wa=wa, words=w, chunk=128))[:u.size]
    got = cuda_tri.tri_probe_plain(ft, t(tab), t(u), t(vl))
    assert np.array_equal(got.numpy(), want)
    assert want.any() and want[(vl & 31) == 31].any()
    out, counts = model_probe(rowptr, colidx, ftw, tab, u, vl)
    assert np.array_equal(out, want)
    est = cuda_tri.probe_loads(ft, t(tab), t(u), t(vl))
    assert {k: est[k] for k in counts} == counts
    assert est["sectors"] <= est["probes"]
    once = cuda_tri.probe_loads(ft, t(tab), t(u), t(vl), window=None)
    assert once["sectors"] <= est["sectors"]


def test_tri_probe_vl_outside_and_ids_outside():
    """The model and plain P agree where bits lie outside [0, 32 words)
    and ids outside [0, V) sit inside runs (JAX clips such bits, so it is
    left out here)."""
    rng = np.random.default_rng(7)
    v, w = 300, 16
    tab = bit31_table(rng, v, w)
    rowptr, colidx, ftw = random_csr(rng, v, 200)
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    u = ordered_ids(rng, "long_runs", v)
    vl = within_runs(rng, u, rng.integers(-40, 32 * w + 40, u.size)
                     .astype(np.int32), "long_runs")
    want = cuda_tri.tri_probe_plain(ft, t(tab), t(u), t(vl)).numpy()
    out, _ = model_probe(rowptr, colidx, ftw, tab, u, vl)
    assert np.array_equal(out, want)
    bad = (vl < 0) | (vl >= 32 * w) | (u < 0) | (u >= v)
    assert bad.any() and not want[bad].any() and want[~bad].any()


# --- I on the task orders it meets ----------------------------------------
#
# Kernel I gives each task a group of I_LANES lanes, which take the shorter
# list's ids I_IDS a lane at a time and search them in lockstep in the
# longer list. The cases give runs longer than a warp's tasks, runs of 1,
# no order, runs across warp edges, ids outside [0, V) inside runs and
# inside rows, empty lists and lists longer than 32 and than 512.

#: JAX's list width here: one compile for every order
I_WIDTH = 128


def model_lists(rowptr, colidx, ftw, u, w, lanes, ids):
    """Kernel I's walk (csrc/tri_support.cu::tri_lists_kernel) in numpy: a
    task with two non-empty lists takes its shorter one (u's on a tie) in
    rounds of lanes * ids slots, slot i0 + l + lanes * k for lane l and
    k < ids; each slot's id is searched in the longer list by the kernel's
    branchless lower bound (ceil(log2 m) halvings to the last slot below
    it, then a compare there and the hit test at the slot after: at most 2
    loads more) and counts where it is in [0, V) and found. Counts, as
    list_loads names them, the shorter lists' ids, the rounds, the search
    loads (at most, padding slots included), the sectors and the dependent
    loads.
    Returns (out, counts)."""
    v = ftw.size
    out = np.zeros(u.size, np.int32)
    got = dict(short_ids=0, rounds=0, search_loads=0, sectors=0, chain=0)

    def ft(x):
        if not 0 <= x < v:
            return 0, 0
        a = int(rowptr[x])
        return a, max(0, min(int(ftw[x]), int(rowptr[x + 1]) - a))

    def search(row, x):                    # (found, loads at most)
        b, m, loads = 0, row.size, 0
        while m > 1:
            half = m >> 1
            b = b + half if row[b + half] < x else b
            m -= half
            loads += 1
        lb = b + (row[b] < x)
        return 0 <= x < v and lb < row.size and row[lb] == x, loads + 2

    for t in range(u.size):
        (pa, la), (pb, lb) = ft(int(u[t])), ft(int(w[t]))
        if la == 0 or lb == 0:
            continue
        if la > lb:
            pa, la, pb, lb = pb, lb, pa, la
        short = colidx[pa:pa + la].astype(np.int64)
        row = colidx[pb:pb + lb].astype(np.int64)
        got["short_ids"] += la
        got["sectors"] += sum((pa + min(la, i + lanes) - 1) // 8 -
                              (pa + i) // 8 + 1 for i in range(0, la, lanes))
        got["sectors"] += (pb + lb - 1) // 8 - pb // 8 + 1
        for i0 in range(0, la, lanes * ids):
            got["rounds"] += 1
            for slot in range(i0, i0 + lanes * ids):
                found, loads = search(row, short[slot] if slot < la else -1)
                out[t] += found
                got["search_loads"] += loads
            got["chain"] += loads
    return out, got


def brute_lists(rowptr, colidx, ftw, u, w):
    """|FT(u) ∩ FT(w)| over the ids in [0, V), a task at a time."""
    v = ftw.size

    def ft(x):
        if not 0 <= x < v:
            return set()
        a = int(rowptr[x])
        ln = max(0, min(int(ftw[x]), int(rowptr[x + 1]) - a))
        return {int(y) for y in colidx[a:a + ln] if 0 <= y < v}

    return np.array([len(ft(int(a)) & ft(int(b))) for a, b in zip(u, w)],
                    np.int32)


def check_model_lists(ft, rowptr, colidx, ftw, u, w, want, shapes):
    """The model at each (lanes, ids) of `shapes` against `want`, and
    list_loads against its counts."""
    for lanes, ids in shapes:
        out, counts = model_lists(rowptr, colidx, ftw, u, w, lanes, ids)
        assert np.array_equal(out, want), (lanes, ids)
        est = cuda_tri.list_loads(ft, t(u), t(w), lanes, ids)
        assert {k: est[k] for k in counts} == counts, (lanes, ids)
        assert est["runs"] == 1 + int((u[1:] != u[:-1]).sum())


@pytest.mark.parametrize("order", ORDERS)
def test_tri_lists_orders(order):
    """I's plain version against JAX's _list_intersect on each task order
    (lists up to 120 ids), the numpy model of the kernel's groups against
    both at the built shape and at 8 lanes of 4 ids, and list_loads against
    what the model counts."""
    rng = np.random.default_rng(9000 + ORDERS.index(order))
    v = 300
    rowptr, colidx, ftw = random_csr(rng, v, 120)
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    u = ordered_ids(rng, order, v)
    w = within_runs(rng, u, rng.integers(-3, v + 3, u.size)
                    .astype(np.int32), order)
    want = np.asarray(jts._list_intersect(
        jnp.asarray(jax_lists(rowptr, colidx, ftw, u, I_WIDTH)),
        jnp.asarray(jax_lists(rowptr, colidx, ftw, w, I_WIDTH)),
        wa=I_WIDTH, wb=I_WIDTH, chunk=256))[:u.size]
    got = cuda_tri.tri_lists_plain(ft, t(u), t(w))
    assert np.array_equal(got.numpy(), want) and want.any()
    check_model_lists(ft, rowptr, colidx, ftw, u, w, want,
                      ((cuda_tri.I_LANES, cuda_tri.I_IDS), (8, 4)))


def test_tri_lists_long_lists_and_ids_outside():
    """Lists longer than 512 ids (up to 800) in sorted runs, rows that hold
    ids outside [0, V) (negative first, V and above last, SENTINEL) and
    empty lists: the plain version and the model against a brute-force
    count over the ids in [0, V), and list_loads against the model."""
    rng = np.random.default_rng(77)
    v = 1500
    deg = rng.integers(0, 120, v)
    deg[rng.choice(v, 40, replace=False)] = rng.integers(520, 800, 40)
    rows = []
    for d in deg:
        r = np.sort(rng.choice(v + 8, int(d), replace=False) - 4)
        if rng.random() < 0.1:
            r = np.append(r, SENTINEL)
        rows.append(r)
    rowptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    colidx = np.concatenate(rows).astype(np.int32)
    ftw = rng.integers(0, deg + 3).astype(np.int32)
    ftw[::11] = 0                                  # empty lists
    long_u = np.nonzero(np.minimum(ftw, deg) > 512)[0]
    assert long_u.size > 5
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    lens = rng.integers(1, 60, 20)
    u = np.repeat(np.sort(rng.choice(long_u, 20)), lens)[:600]
    u = np.concatenate([u, ordered_ids(rng, "window_edges", v, 300)])
    w = np.concatenate([rng.choice(long_u, u.size // 3),
                        rng.integers(-2, v + 2, u.size - u.size // 3)])
    w = within_runs(rng, u, rng.permutation(w).astype(np.int32), "long")
    u = u.astype(np.int32)
    want = brute_lists(rowptr, colidx, ftw, u, w)
    got = cuda_tri.tri_lists_plain(ft, t(u), t(w))
    assert np.array_equal(got.numpy(), want) and want.max() > 100
    check_model_lists(ft, rowptr, colidx, ftw, u, w, want,
                      ((cuda_tri.I_LANES, cuda_tri.I_IDS),))


# --- H: per-edge 3-walk support over per-list column counts -------------
#
# house_t3(ft, tab, a, b)[t] = Σ_{x ∈ L(a_t)} popcount(tab[x] & tab[b_t]).
# The plain version against a numpy definition; a numpy model of the
# kernel's walk (csrc/house_t3.cu) over plan_house's items: block items
# with whole-list int32 counts (rows by the view's ids, or without the view
# by their table rows' bits), each task dotted once over its ids or its
# row's bits; warp items with counts in planes and the carry-save plane
# dot; with and without the sparse view, the default plan, small cuts and
# plans of one kind, shuffled items; the plan's cover of every (task, list
# slot) pair and its density threshold at and on both sides of a list's
# average; the two calls of the house engine against JAX's _t3_edges, and
# house_bytes.

def house_csr(rng, v, max_deg, n_long=0, long_len=(1100, 1500)):
    """Rows with ids outside [0, v) (negative, v and above, SENTINEL),
    n_long rows of long_len slots, ftw in [-1, deg + 2] with some lists
    empty."""
    deg = rng.integers(0, max_deg + 1, v)
    deg[rng.choice(v, n_long, replace=False)] = rng.integers(*long_len,
                                                             n_long)
    colidx = rng.integers(-3, v + 3, int(deg.sum())).astype(np.int32)
    colidx[::97] = SENTINEL
    ftw = rng.integers(-1, deg + 3).astype(np.int32)
    ftw[::13] = 0
    ftw[np.argsort(-deg)[:n_long]] = deg[np.argsort(-deg)[:n_long]]
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int64), colidx, ftw


def house_definition(rowptr, colidx, ftw, tab, a, b):
    """Σ over x in L(a_t) (ids in [0, V)) of popcount(tab[x] & tab[b_t]),
    int64, task by task: the bits of tab[b_t] times the column sums of the
    rows of L(a_t), each list's summed once."""
    v = tab.shape[0]
    bits = np.unpackbits(tab.view(np.uint8), axis=1).astype(np.int64)
    out = np.zeros(a.size, dtype=np.int64)
    sums = {}
    for i, (x0, y) in enumerate(zip(a, b)):
        if not (0 <= x0 < v and 0 <= y < v):
            continue
        if x0 not in sums:
            n = max(0, min(int(ftw[x0]), int(rowptr[x0 + 1] - rowptr[x0])))
            xs = colidx[rowptr[x0]:rowptr[x0] + n]
            sums[x0] = bits[xs[(xs >= 0) & (xs < v)]].sum(axis=0)
        out[i] = int(bits[y] @ sums[x0])
    return out


def column_bits(tab):
    """int64 [V, 32 words]: column c of row x is bit c % 32 of word c // 32."""
    return np.unpackbits(np.ascontiguousarray(tab).view(np.uint8), axis=1,
                         bitorder="little").astype(np.int64)


def csa(a, b, c):
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def plane_dot(cnt, w, np_):
    """The kernel's carry-save plane dot (csrc/house_t3.cu::chunk_dot) of
    the counts cnt (int64 [32 words]) against rows w (uint32 [m, words]):
    planes i < np_ of the counts, each lane's four words and the three
    carries from the plane below reduced to one word a plane, summed over
    the lanes. int64 [m]."""
    m, words = w.shape
    assert cnt.max(initial=0) < 1 << np_
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    bc = lambda x: np.bitwise_count(x).astype(np.int64)
    s = np.zeros((m, words // 4), dtype=np.int64)
    c0 = c1 = c2 = np.zeros((m, words // 4), dtype=np.uint32)
    for i in range(np_):
        p = np.packbits(((cnt >> i) & 1).astype(np.uint8),
                        bitorder="little").view(np.uint32)
        x = (p[None, :] & w).reshape(m, -1, 4)
        h1, l1 = csa(x[..., 0], x[..., 1], x[..., 2])
        h2, l2 = csa(x[..., 3], c0, c1)
        h3, l3 = csa(l1, l2, c2)
        s += bc(l3) << i
        c0, c1, c2 = h1, h2, h3
    s += (bc(c0) + bc(c1) + bc(c2)) << np_
    return s.sum(axis=1)


def model_house(tab, rowptr, colidx, ftw, a, b, plan, view=None):
    """Kernel H's walk in numpy over plan = (items, n_block), a stretch of
    128 words at a time. A block item: int32 counts of its whole list, each
    row adding its columns, by the view's ids with the view, else by its
    table row's bits; then each task dotted once, summing the counts at its
    view ids or, without the view, at its row's set bits. A warp item: the
    counts in planes (below 2^11), every task by the carry-save plane dot.
    view = (nbc, cs) or None."""
    items, n_block = plan
    v, words = tab.shape
    bits = column_bits(tab)
    uw = tab.view(np.uint32)
    out = np.zeros(a.size, dtype=np.int64)
    nbc, cs = view if view is not None else (None, 0)

    def suffix(ys, col0, cols):
        """(row index, column) of the view's ids of rows ys in the
        stretch."""
        k = nbc[ys]
        j = np.repeat(np.arange(ys.size), k)
        pos = np.repeat(rowptr[ys + 1] - k, k) + np.arange(j.size) - \
            np.repeat(np.cumsum(k) - k, k)
        c = colidx[pos].astype(np.int64) - cs - col0
        ok = (c >= 0) & (c < cols)
        return j[ok], c[ok]

    for idx, (t0, nt, s0, ns) in enumerate(items.astype(np.int64)):
        x0 = a[t0]
        assert 0 <= x0 < v and (a[t0:t0 + nt] == x0).all()
        ln = min(max(int(ftw[x0]), 0), int(rowptr[x0 + 1] - rowptr[x0]))
        assert ns >= 1 and s0 + ns <= ln
        xs = colidx[rowptr[x0] + s0:rowptr[x0] + s0 + ns].astype(np.int64)
        xs = xs[(xs >= 0) & (xs < v)]
        ys = b[t0:t0 + nt].astype(np.int64)
        tv = np.flatnonzero((ys >= 0) & (ys < v))
        ys = ys[tv]
        for q0 in range(0, words, 128):
            col0, cols = 32 * q0, 32 * min(128, words - q0)
            sl = slice(col0, col0 + cols)
            if idx >= n_block:
                assert ns < 1 << 11
                cnt = bits[xs, sl].sum(axis=0)
                out[t0 + tv] += plane_dot(cnt, uw[ys, q0:q0 + cols // 32],
                                          int(ns).bit_length())
                continue
            if view is None:
                cnt = bits[xs, sl].sum(axis=0)
                out[t0 + tv] += bits[ys, sl] @ cnt
                continue
            cnt = np.zeros(cols, dtype=np.int64)
            np.add.at(cnt, suffix(xs, col0, cols)[1], 1)
            j, c = suffix(ys, col0, cols)
            np.add.at(out, t0 + tv[j], cnt[c])
    return out


def house_plan(rowptr, colidx, ftw, tab, a, view=None, **kw):
    """plan_house over numpy inputs on the CPU: (items, n_block,
    longest)."""
    from graphminer_tpu_torch.ops import cuda_house as ch
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    hv = None if view is None else ch.HouseView(t(view[0]), view[1])
    plan = ch.plan_house(ft, t(tab), t(a), hv, **kw)
    assert plan.n_tasks == a.size and plan.items.dtype == torch.int32
    return plan.items.numpy(), plan.n_block, plan.longest


#: small cuts: warp and block pieces, warp items for lists whose rows hold
#: more than 6 set bits on average, segments of 40 slots
SMALL_CUT = dict(piece=37, block_piece=53, warp_seg=40, sparse=6)


HOUSE_CASES = (("long_runs", 8, 0), ("runs_of_1", 4, 0),
               ("unsorted", 12, 0), ("window_edges", 8, 3),
               ("long_lists", 8, 6))


def house_case(order, w, n_long):
    """(tab, rowptr, colidx, ftw, a, b) of a HOUSE_CASES case: bit 31 in
    every word, a third of the rows sparse (at most ~3 set bits a word);
    "long_lists" has lists of 2,000-5,000 ids and runs of 1,100-1,600
    tasks (longer than a piece) on them."""
    rng = np.random.default_rng(w + n_long)
    v = 400
    tab = bit31_table(rng, v, w)
    sparse = rng.random(v) < 1 / 3
    tab[sparse] &= words(rng, int(sparse.sum()), w) & \
        words(rng, int(sparse.sum()), w) & words(rng, int(sparse.sum()), w)
    long_len = (2000, 5001) if order == "long_lists" else (1100, 1500)
    rowptr, colidx, ftw = house_csr(rng, v, 60, n_long, long_len)
    if order == "long_lists":
        lens = rng.integers(1100, 1601, 3)
        a = np.repeat(np.argsort(-np.diff(rowptr))[:3], lens)
        a = np.concatenate([a, ordered_ids(rng, "window_edges", v, 1500)])
        a = a.astype(np.int32)
    else:
        a = ordered_ids(rng, order, v, 3000)
    b = ordered_ids(rng, "unsorted", v, a.size)
    return tab, rowptr, colidx, ftw, a, b


@pytest.mark.parametrize("order,w,n_long", HOUSE_CASES)
def test_house_t3_plain_equals_definition(order, w, n_long):
    """The plain version and the kernel's walk against the definition:
    bit 31 in every word, sparse and dense rows, ids outside [0, V) as a,
    as b and in the lists, empty lists, runs of 1, runs longer than a
    piece, no order, lists longer than the first design's segments; the
    default plan, small cuts and plans of block or warp items alone."""
    from graphminer_tpu_torch.ops import cuda_house
    tab, rowptr, colidx, ftw, a, b = house_case(order, w, n_long)
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    want = house_definition(rowptr, colidx, ftw, tab, a, b)
    got = cuda_house.house_t3(ft, t(tab), t(a), t(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.max() > 0 and (want == 0).any()
    kinds = set()
    for kw in ({}, SMALL_CUT, dict(sparse=-1), dict(sparse=1 << 20)):
        items, n_block, _ = house_plan(rowptr, colidx, ftw, tab, a, **kw)
        got = model_house(tab, rowptr, colidx, ftw, a, b, (items, n_block))
        assert np.array_equal(got, want), kw
        kinds |= {"block"} if n_block else set()
        kinds |= {"warp"} if n_block < items.shape[0] else set()
        if order == "long_lists" and kw.get("sparse") == 1 << 20:
            assert (items[:, 3] > 1024).any() and \
                (items[:, 1] > cuda_house.PIECE).any()
    assert kinds == {"block", "warp"}


def house_view_case(seed, v=3000, c=256, n_long=8):
    """A graph-like CSR (sorted rows without repeats, n_long rows of
    1,000-2,500 ids) and its core bitmap table, whose row x is the ids >= cs
    of row x less cs: (tab, rowptr, colidx, ftw, nbc, cs)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 80, v)
    deg[rng.choice(v, n_long, replace=False)] = rng.integers(1000, 2500,
                                                             n_long)
    hot = np.arange(v - c, v)
    rows = [np.unique(np.concatenate([rng.choice(v, d, replace=False),
                                      rng.choice(hot, d // 3)]))
            for d in deg]
    rowptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    colidx = np.concatenate(rows).astype(np.int32)
    cs = v - c
    src = np.repeat(np.arange(v), np.diff(rowptr))
    core = colidx >= cs
    tab = np.zeros((v, c // 32), dtype=np.uint32)
    cc = colidx[core].astype(np.int64) - cs
    np.bitwise_or.at(tab, (src[core], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    nbc = np.bincount(src[core], minlength=v).astype(np.int32)
    deg = np.diff(rowptr)
    ftw = np.where(rng.random(v) < 0.5, deg, rng.integers(-1, deg + 3))
    return (tab.view(np.int32), rowptr.astype(np.int64), colidx,
            ftw.astype(np.int32), nbc, cs)


@pytest.mark.parametrize("seed,v,c", [(0, 3000, 256), (1, 8000, 5120)])
def test_house_t3_model_with_view(seed, v, c):
    """With the sparse view (a table made from the CSR's core suffixes, 8
    or 160 words: two stretches): the plain version, and the walk with the
    view and without it, equal the definition, over the view's plan and
    the popcounts', at small cuts, the default and plans of one kind."""
    from graphminer_tpu_torch.ops import cuda_house
    tab, rowptr, colidx, ftw, nbc, cs = house_view_case(seed, v, c)
    v = tab.shape[0]
    rng = np.random.default_rng(seed + 10)
    a = ordered_ids(rng, "long_runs", v, 2500)
    b = ordered_ids(rng, "unsorted", v, a.size)
    assert np.array_equal(column_bits(tab).sum(1), nbc)
    ft = FtLists.from_csr(rowptr, colidx, ftw, "cpu")
    want = house_definition(rowptr, colidx, ftw, tab, a, b)
    got = cuda_house.house_t3(ft, t(tab), t(a), t(b),
                              view=cuda_house.HouseView(t(nbc), cs))
    assert np.array_equal(got.numpy(), want) and want.max() > 0
    for kw in (SMALL_CUT, {}, dict(sparse=-1), dict(sparse=1 << 20)):
        for view in ((nbc, cs), None):
            items, n_block, _ = house_plan(rowptr, colidx, ftw, tab, a,
                                           view, **kw)
            for model_view in ((nbc, cs), None):
                got = model_house(tab, rowptr, colidx, ftw, a, b,
                                  (items, n_block), model_view)
                assert np.array_equal(got, want), (kw, view, model_view)
    assert nbc.max() > 128 and np.median(nbc) < 64


def test_house_plan_covers_each_pair_once():
    """plan_house covers each (task, list slot) pair exactly once, at the
    default cut and small ones, tasks with an empty list not at all; its
    items are pieces of one run, block items first, each kind heaviest
    first, a list's items block items exactly when its rows' set bits are
    at most LIST_SPARSE times its length (the threshold set at a list's
    average and on either side of it); the kernel's walk over shuffled
    items or other cuts gives the same result."""
    from graphminer_tpu_torch.ops import cuda_house
    tab, rowptr, colidx, ftw, a, b = house_case("long_lists", 8, 6)
    v = tab.shape[0]
    ok = (a >= 0) & (a < v)
    x = np.where(ok, a, 0)
    ln = np.where(ok, np.minimum(np.clip(ftw[x], 0, None),
                                 rowptr[x + 1] - rowptr[x]), 0)
    want = house_definition(rowptr, colidx, ftw, tab, a, b)
    rng = np.random.default_rng(3)
    pc = column_bits(tab).sum(1)
    row_sum = {}                                 # each list's set bits
    for x0, k in zip(x, ln):
        if (x0, k) not in row_sum:
            xs = colidx[rowptr[x0]:rowptr[x0] + k]
            row_sum[x0, k] = int(pc[xs[(xs >= 0) & (xs < v)]].sum())
    dsum = np.array([row_sum[x0, k] for x0, k in zip(x, ln)])
    j = np.flatnonzero((ln > 0) & (dsum % np.maximum(ln, 1) == 0))[0]
    avg = int(dsum[j] // ln[j])                  # a list's exact average
    for kw in ({}, SMALL_CUT, dict(piece=1, block_piece=2, warp_seg=3),
               dict(sparse=-1), dict(sparse=1 << 20), dict(sparse=avg),
               dict(sparse=avg - 1), dict(sparse=avg + 1)):
        items, n_block, longest = house_plan(rowptr, colidx, ftw, tab, a,
                                             **kw)
        assert longest == ln.max()
        sparse = kw.get("sparse", cuda_house.LIST_SPARSE)
        first = items[:, 0]
        assert np.array_equal(np.arange(items.shape[0]) < n_block,
                              dsum[first] <= sparse * ln[first]), kw
        assert (items[n_block:, 3] <= kw.get("warp_seg",
                                              cuda_house.WARP_SEG)).all()
        assert np.array_equal(items[:n_block, 3], ln[first[:n_block]])
        cover = np.zeros((a.size, int(ln.max())), dtype=np.int32)
        for t0, nt, s0, ns in items:
            assert (a[t0:t0 + nt] == a[t0]).all() and nt >= 1 and ns >= 1
            cover[t0:t0 + nt, s0:s0 + ns] += 1
        assert np.array_equal(cover, (np.arange(cover.shape[1])[None, :] <
                                      ln[:, None]).astype(np.int32)), kw
        weight = items[:, 1].astype(np.int64) + items[:, 3]
        for part in (weight[:n_block], weight[n_block:]):
            assert (np.diff(part) <= 0).all()
        if kw is SMALL_CUT or kw.get("piece") == 1 or "sparse" in kw and \
                abs(kw["sparse"] - avg) <= 1:
            continue                       # the walk's cuts: other tests
        perm = np.concatenate([rng.permutation(n_block),
                               n_block + rng.permutation(items.shape[0] -
                                                         n_block)])
        got = model_house(tab, rowptr, colidx, ftw, a, b,
                          (items[perm], n_block))
        assert np.array_equal(got, want), kw


def test_house_t3_empty_and_bounds():
    """No task: an empty result and plan; every list empty: zeros and no
    item; a call whose longest list times 32 words could pass int32 is
    refused; a plan of another call and a view of another shape too."""
    from graphminer_tpu_torch.ops import cuda_house
    _, tab, rowptr, colidx, ftw, ft = fixture(3)
    e = t(np.zeros(0, np.int32))
    n0 = cuda_house.house_t3.launches
    assert cuda_house.house_t3(ft, t(tab), e, e).shape == (0,)
    assert cuda_house.plan_house(ft, t(tab), e).items.shape == (0, 4)
    ft0 = FtLists.from_csr(rowptr, colidx, np.zeros_like(ftw), "cpu")
    ids = t(np.arange(ftw.size))
    assert not cuda_house.house_t3(ft0, t(tab), ids, ids).any()
    plan = cuda_house.plan_house(ft0, t(tab), ids)
    assert plan.items.shape == (0, 4) and plan.longest == 0
    big = FtLists(rowptr=torch.tensor([0, 1 << 24], dtype=torch.int64),
                  colidx=torch.zeros(1 << 24, dtype=torch.int32),
                  ftw=torch.tensor([1 << 24], dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_house.house_t3(big, torch.zeros((1, 8), dtype=torch.int32),
                            t([0]), t([0]))
    with pytest.raises(ValueError):
        cuda_house.house_t3(ft0, t(tab), ids, ids, plan=cuda_house.plan_house(
            ft0, t(tab), ids[:3]))
    with pytest.raises(ValueError):
        cuda_house.house_t3(ft0, t(tab), ids, ids, view=cuda_house.HouseView(
            t(np.zeros(3)), 0))
    assert cuda_house.house_t3.launches == n0          # the CPU launches none


def test_house_calls_equal_jax_t3_edges():
    """H's two calls (the whole rows with tasks (u, v); FT with tasks
    (v, u)) plus the bridge's t3ss give JAX's _t3_edges + t3ss (edge_t3)
    at core 32, edge for edge."""
    from graphminer_tpu.core.graph import HostGraph as JHostGraph
    from graphminer_tpu.ops import house as jh
    from graphminer_tpu_torch import native_bridge
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import house, tri_support
    from graphminer_tpu_torch.ops.cuda_house import house_t3
    g = rmat(9, 8, seed=2)
    rg = g.relabel_by_degree(descending=False)
    c, cs, words_ = tri_support.core_split(rg, 32)
    deg, core_nb = tri_support.core_neighbours(rg, cs)
    tab = t(tri_support._pack_full_core_bitmaps(rg, cs, words_))
    src, dst = house._dag_edges(rg)
    rows = FtLists.from_csr(rg.rowptr, rg.colidx, deg, "cpu")
    ft = FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb, "cpu")
    ss = native_bridge.t3ss(rg.rowptr, rg.colidx, cs)[
        rg.colidx > np.repeat(np.arange(rg.n_vertices), deg)]
    got = house_t3(rows, tab, t(src), t(dst)).numpy().astype(np.int64) + \
        house_t3(ft, tab, t(dst), t(src)).numpy() + ss
    _, jsrc, jdst, want = jh.edge_t3(
        JHostGraph(rowptr=g.rowptr, colidx=g.colidx), core=32)
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    assert np.array_equal(got, want) and ss.any()


def test_house_bytes_adds_up():
    """12 B a task, each distinct a's list (20 B of bounds and 4 B an id)
    and each distinct row a list slot or a b names (ids in [0, V))."""
    from graphminer_tpu_torch.utils.profiling import house_bytes
    rowptr = np.array([0, 2, 3, 5, 5], dtype=np.int64)
    colidx = np.array([1, 2, 7, 3, -1], dtype=np.int32)
    ft = FtLists.from_csr(rowptr, colidx, np.array([2, 9, 1, 0]), "cpu")
    tab = torch.zeros((4, 8), dtype=torch.int32)
    a, b = t([0, 0, 2, 3, 9]), t([3, 1, 0, 0, 5])
    # lists: 0 -> [1, 2], 2 -> [3], 3 -> [] (a 9 names none);
    # rows: {1, 2, 3} from the lists, {3, 1, 0} from b: 4 rows of 32 B
    assert house_bytes(ft, tab, a, b) == \
        12 * 5 + (20 * 3 + 4 * 3) + 4 * 8 * 4
