"""Kernel W's pairs mode (ops/cuda_colsum.py: plan_pairs, colsum_pairs,
colsum_finish, pairs_count) on the CPU, where its plain versions run:
against the JAX package's rectangle level 0 (graphminer_tpu/ops/
rectangle.py::_case_a + ::_case_b, summed through _sum_lohi), against the
product-form yardstick it replaced (ops/slab_form.py::
rectangle_level0_slab), and against a numpy reading of its definition on
random tables with bit 31 set, rows of degree 0 and 1, ids outside [0, V)
and rows split at cuts of 2 and 4 slots. A numpy model of the kernel's
bit-sliced counters and its popcount epilogue is held to the direct sum.
Inputs from numpy seeds; all exact. The kernels themselves run only on a
card (tests/test_torch_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import rectangle as jr
from graphminer_tpu.ops import tri_support as jts
from graphminer_tpu.ops.hubcore import _expand_bits as jexpand
from graphminer_tpu.types import SENTINEL
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.ops import cuda_colsum as cc
from graphminer_tpu_torch.ops import tri_support as ts
from graphminer_tpu_torch.ops.cuda_tri import FtLists
from graphminer_tpu_torch.ops.slab_form import rectangle_level0_slab


def jax_level0(rg, core):
    """Cases A and B of the JAX engine at `core` on the relabeled rg, as
    its rectangle_count_fast runs them (M and the case-B classes built as
    it builds them)."""
    jg = JHostGraph(rowptr=rg.rowptr, colidx=rg.colidx)
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    c, cs, words = ts.core_split(rg, core)
    cpad = 32 * words
    table = jnp.asarray(jts._pack_full_core_bitmaps(jg, cs, words))
    acc_rows = table[cs:]
    colsrc = np.repeat(np.arange(v, dtype=np.int64), deg)
    core_nb = np.bincount(colsrc[rg.colidx >= cs], minlength=v)
    keep = np.nonzero((core_nb >= 2) & (np.arange(v) < cs))[0]
    gs = (jr._gram_rows(table[jnp.asarray(keep)], words=words,
                        slab=jr.GRAM_SLAB)
          if keep.size else jnp.zeros((cpad, cpad), jnp.int32))
    total = jr._sum_lohi(jr._case_a(gs, acc_rows, words=words, c=c,
                                    block=jr.BLOCK))
    if not cs:
        return total
    x = jexpand(acc_rows, cpad)
    x = jnp.concatenate([x, jnp.zeros((cpad - x.shape[0], cpad), x.dtype)])
    i, j = np.indices((cpad, cpad))
    m_masked = jnp.where(jnp.asarray(i < j), x, 0)
    ftw = deg[:cs] - core_nb[:cs]
    classes = jr._cover(jr.FT_CLASSES, int(ftw.max(initial=1)))
    wcl = np.where(ftw == 0, 0, jr._class_of(np.maximum(ftw, 1), classes))
    for k in sorted(set(wcl.tolist())):
        us = np.arange(cs)[wcl == k]
        npad = max(us.size, 8) + (-max(us.size, 8)) % 8
        uu = np.full(npad, SENTINEL, dtype=np.int32)
        uu[:us.size] = us
        ft = np.zeros((npad, int(k)), dtype=np.int32)
        if k:
            ft = np.full((npad, int(k)), SENTINEL, dtype=np.int32)
            ft[:us.size] = jr._ft_sub_lists(jg, us, int(k), cs)
        ch = max(8, min(jr.CHUNK_U, (1 << 16) // max(int(k), 1) // 8 * 8))
        total += jr._sum_lohi(jr._case_b(
            table, m_masked, jnp.asarray(uu), jnp.asarray(ft), words=words,
            wa=int(k), chunk=ch, c=c, block=jr.BLOCK))
    return total


def port_level0(rg, core, cut=cc.SEG_CUT, u=None):
    """The engine's level 0 by the plain versions, and its plan."""
    c, cs, words = ts.core_split(rg, core)
    table = torch.from_numpy(ts._pack_full_core_bitmaps(rg, cs, words))
    u = torch.arange(rg.n_vertices, dtype=torch.int32) if u is None else u
    plan = cc.plan_pairs(torch.from_numpy(rg.rowptr.astype(np.int64)),
                         torch.from_numpy(rg.colidx.astype(np.int32)), u,
                         cs, c, cut)
    return cc.pairs_count(plan, table), plan


def yardstick_level0(rg, core):
    c, cs, words = ts.core_split(rg, core)
    table = torch.from_numpy(ts._pack_full_core_bitmaps(rg, cs, words))
    deg, core_nb = ts.core_neighbours(rg, cs)
    ft = FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb, "cpu")
    keep = np.nonzero((core_nb >= 2) & (np.arange(rg.n_vertices) < cs))[0]
    return rectangle_level0_slab(table, ft, cs, c, keep)


def relabeled(g):
    if not isinstance(g, HostGraph):
        g = HostGraph(rowptr=g.rowptr, colidx=g.colidx)
    return g.relabel_by_degree(descending=False)


GRAPHS = {"er120": lambda: erdos_renyi(120, 0.1, 3),
          "er300": lambda: erdos_renyi(300, 0.04, 5),
          "rmat10": lambda: rmat(10, 8, seed=4),
          "rmat11": lambda: rmat(11, 8, seed=3)}


@pytest.mark.parametrize("core", [8, 32, 100])
@pytest.mark.parametrize("gi", [0, 1, 3])
def test_level0_equals_jax_rand_graphs(rand_graphs, gi, core):
    rg = relabeled(rand_graphs[gi])
    got, _ = port_level0(rg, core)
    assert got == jax_level0(rg, core)


@pytest.mark.parametrize("name,core", [
    ("er120", 8), ("er120", 32), ("er120", 100), ("er300", 32),
    ("er300", 100), ("rmat10", 128), ("rmat10", 256), ("rmat11", 128),
    ("rmat11", 256)])
def test_level0_equals_jax_and_yardstick(name, core):
    rg = relabeled(GRAPHS[name]())
    got, plan = port_level0(rg, core)
    assert got > 0
    assert got == jax_level0(rg, core) == yardstick_level0(rg, core)


@pytest.mark.parametrize("cut", [2, 4, 9])
@pytest.mark.parametrize("name,core", [("er120", 32), ("rmat10", 128),
                                       ("rmat11", 100)])
def test_split_rows_same_count(name, core, cut):
    """Rows cut into segments (their counts added in the scratch, then
    finished) give the unsplit count."""
    rg = relabeled(GRAPHS[name]())
    want, whole = port_level0(rg, core)
    got, plan = port_level0(rg, core, cut=cut)
    assert whole.long_u.numel() == 0 and plan.long_u.numel() > 0
    assert got == want
    it = plan.items.long()
    assert (it[:, 2] <= cut).all() and (it[:-1, 2] >= it[1:, 2]).all()
    assert int(it[:, 2].sum()) == int(whole.items[:, 2].long().sum())


def definition(rowptr, colidx, tab, u, cs, c):
    """numpy: Σ over valid u with deg >= 2 of Σ_{col < c, col > u - cs
    (u core)} C(w_u[col], 2), w_u[col] = Σ_{x ∈ row u, x ∈ [0, V)} bit col
    of tab[x] (col > x - cs when x core)."""
    v, words = tab.shape
    bits = np.unpackbits(tab.view(np.uint8), bitorder="little",
                         axis=1).astype(np.int64)
    col = np.arange(32 * words)
    total = 0
    for x0 in u:
        if not 0 <= x0 < v or rowptr[x0 + 1] - rowptr[x0] < 2:
            continue
        w = np.zeros(32 * words, np.int64)
        for x in colidx[rowptr[x0]:rowptr[x0 + 1]]:
            if 0 <= x < v:
                w += bits[x] * (col > (x - cs if x >= cs else -1))
        keep = (col < c) & (col > (x0 - cs if x0 >= cs else -1))
        total += int((w * (w - 1) // 2)[keep].sum())
    return total


def random_case(seed, v=90, words=4, max_deg=30):
    rng = np.random.default_rng(seed)
    tab = rng.integers(-2**31, 2**31, (v, words), dtype=np.int64
                       ).astype(np.int32)
    tab[:, -1] |= np.int32(-2**31)                 # bit 31 in every row
    deg = rng.integers(0, max_deg + 1, v)
    deg[:6] = [0, 1, 0, 1, 2, max_deg]             # rows of degree 0 and 1
    rows = [rng.integers(-3, v + 3, d) for d in deg]   # ids outside [0, v)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    colidx = np.concatenate(rows).astype(np.int32)
    u = np.concatenate([np.arange(v), [-1, v, v + 7, 3]]).astype(np.int32)
    return rowptr, colidx, tab, u


@pytest.mark.parametrize("cut", [2, 4, 1024])
@pytest.mark.parametrize("seed,cs,c", [(0, 60, 30), (1, 20, 128),
                                       (2, 0, 100), (3, 85, 127)])
def test_pairs_plain_equals_definition(seed, cs, c, cut):
    rowptr, colidx, tab, u = random_case(seed)
    plan = cc.plan_pairs(torch.from_numpy(rowptr), torch.from_numpy(colidx),
                         torch.from_numpy(u), cs, c, cut)
    got = cc.pairs_count(plan, torch.from_numpy(tab))
    assert got == definition(rowptr, colidx, tab, u, cs, c) > 0
    assert (plan.items[:, 2] >= 1).all()


def test_plan_drops_short_rows_and_bad_ids():
    rowptr, colidx, tab, u = random_case(0)
    plan = cc.plan_pairs(torch.from_numpy(rowptr), torch.from_numpy(colidx),
                         torch.from_numpy(u), 60, 30, 8)
    deg = np.diff(rowptr)
    rows = set(plan.items[:, 0].tolist())
    assert rows == {int(x) for x in range(tab.shape[0]) if deg[x] >= 2}
    assert set(plan.long_u.tolist()) == {int(x) for x in rows if deg[x] > 8}


def test_empty_task_list():
    rowptr, colidx, tab, _ = random_case(1)
    e = torch.zeros(0, dtype=torch.int32)
    plan = cc.plan_pairs(torch.from_numpy(rowptr), torch.from_numpy(colidx),
                         e, 10, 100)
    assert plan.items.shape == (0, 4) and plan.long_u.shape == (0,)
    total, counts = cc.colsum_pairs(plan, torch.from_numpy(tab))
    assert total.tolist() == [0] and counts.shape == (0, 128)
    assert cc.pairs_count(plan, torch.from_numpy(tab)) == 0


def test_pairs_refuse_bad_arguments():
    rowptr, colidx, tab, u = random_case(2)
    rp, ci, t, uu = (torch.from_numpy(a) for a in (rowptr, colidx, tab, u))
    for cut in (0, 1 << 16):
        with pytest.raises(ValueError):
            cc.plan_pairs(rp, ci, uu, 10, 20, cut)
    with pytest.raises(TypeError):
        cc.plan_pairs(rp.int(), ci, uu, 10, 20)
    with pytest.raises(TypeError):
        cc.plan_pairs(rp, ci.long(), uu, 10, 20)
    plan = cc.plan_pairs(rp, ci, uu, 10, 20, 4)
    with pytest.raises(ValueError):                  # one row a vertex
        cc.colsum_pairs(plan, t[:-1])
    with pytest.raises(ValueError):                  # c past the columns
        cc.colsum_pairs(cc.plan_pairs(rp, ci, uu, 10, 129), t)
    with pytest.raises(TypeError):
        cc.colsum_pairs(plan, t.long())
    total, counts = cc.colsum_pairs(plan, t)
    with pytest.raises(ValueError):
        cc.colsum_finish(plan, counts[1:], total)
    with pytest.raises(ValueError):
        cc.colsum_finish(plan, counts, total.int())


def planes_of(w):
    return [sum(((int(x) >> i) & 1) << b for b, x in enumerate(w))
            for i in range(16)]


def epilogue(p, om, np_):
    popc = lambda a: bin(a).count("1")
    hi = 0
    for i in range(1, np_):
        hi |= p[i]
    if not hi & om:
        return 0
    s = 0
    for i in range(np_):
        a = p[i] & om
        if i:
            s += (popc(a) * ((1 << i) - 1)) << (i - 1)
        for j in range(i + 1, np_):
            s += popc(a & p[j]) << (i + j)
    return s


def ripple(p, carry, start=0):
    for i in range(start, 16):
        if not carry:
            break
        p[i], carry = p[i] ^ carry, p[i] & carry


def csa(a, b, c):
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def add_eight(p, w):
    """The kernel's add_eight: a carry-save tree sums 8 words into 4 bit
    planes, full adders add them to planes 0-3, the carry ripples on."""
    h1, l1 = csa(w[0], w[1], w[2])
    h2, l2 = csa(w[3], w[4], w[5])
    h3, l3 = csa(l1, l2, w[6])
    h4 = l3 & w[7]
    h5, l5 = csa(h1, h2, h3)
    h6 = l5 & h4
    s = [l3 ^ w[7], l5 ^ h4, h5 ^ h6, h5 & h6]
    c = 0
    for i in range(4):
        a, u = p[i], p[i] ^ s[i]
        p[i], c = u ^ c, (a & s[i]) | (u & c)
    ripple(p, c, 4)


@pytest.mark.parametrize("n", [7, 3000])
def test_bit_sliced_counters_model(n):
    """The kernel's adds in numpy: words 8 at a time through add_eight, the
    rest one at a time through the ripple of half adders, keep each
    column's count in the 16 bit planes."""
    rng = np.random.default_rng(n)
    words = [int(x) for x in rng.integers(0, 2**32, n, dtype=np.uint64)]
    for i in range(0, n, 3):
        words[i] &= 0x80000001                   # bit 31, and sparse
    for i in range(0, n, 7):
        words[i] = 0
    w = np.zeros(32, np.int64)
    p = [0] * 16
    for wd in words:
        w += (wd >> np.arange(32)) & 1
    for s in range(0, n - 7, 8):
        add_eight(p, words[s:s + 8])
    for wd in words[n - n % 8:]:
        ripple(p, wd)
    assert p == planes_of(w)


@pytest.mark.parametrize("length", [1, 2, 3, 5, 31, 200, 1024, 65535])
def test_bit_sliced_epilogue_model(length):
    """The kernel's epilogue in numpy: Σ_b C(w_b, 2) over the masked
    columns as Σ_{i<j} 2^(i+j) popc(p_i & p_j) + Σ_i 2^(i-1) (2^i - 1)
    popc(p_i), over the planes a segment of `length` slots reaches, a word
    whose counts are all <= 1 skipped."""
    rng = np.random.default_rng(length)
    for _ in range(20):
        w = rng.integers(0, length + 1, 32)
        w[rng.random(32) < 0.3] = rng.integers(0, 2, 1)
        om = int(rng.integers(0, 2**32)) | (1 << 31)
        keep = (om >> np.arange(32)) & 1
        assert epilogue(planes_of(w), om, length.bit_length()) == \
            int((w * (w - 1) // 2 * keep).sum())
