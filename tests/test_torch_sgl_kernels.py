"""The plain PyTorch versions of kernels S, P, I (ops/cuda_tri.py) and W
(ops/cuda_colsum.py) against the JAX package's expressions they replace
(graphminer_tpu/ops/tri_support.py::_bitmap_tri, ::_subcore_bit_probe,
::_list_intersect and the wsub sum of ops/rectangle.py::_case_b) on random
inputs from numpy seeds: words with bit 31 set, lists read in place from a
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
    from graphminer_tpu_torch.io.synth import rmat
    with pytest.raises(SystemExit) as e:
        sgl_count(rmat(8, 8, seed=1), "house", fast=True, device="cpu")
    assert "ROADMAP.md" in str(e.value) and "item 6c" in str(e.value)
