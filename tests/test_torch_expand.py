"""Kernel X's plain version (graphminer_tpu_torch/ops/cuda_expand.py, the
CPU path of hubcore._expand_bits) against the JAX package's _expand_bits
and the gather-ANDs of its clique engines, and the port bridge's native
expand_emit against the JAX bridge's. Inputs from numpy seeds; all exact."""
import numpy as np
import pytest
import torch

from graphminer_tpu import native_bridge as jbridge
from graphminer_tpu.ops import hubcore as jhub
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.ops import cliquek, hubcore
from graphminer_tpu_torch.ops.cuda_expand import expand_bits, \
    expand_bits_plain

SENTINEL = np.iinfo(np.int32).max


def words(rng, *shape):
    """Random int32 words, about half with bit 31 set, and bit 31 set in
    every word of row 0 (core-local ids ≡ 31 mod 32)."""
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w[0] |= np.int32(-2**31)
    return w


def jax_bits(y):
    """JAX _expand_bits of int32 rows [n, hw], as int8 numpy."""
    y = np.asarray(y, dtype=np.int32)
    return np.asarray(jhub._expand_bits(y, y.shape[1] * 32)).astype(np.int8)


@pytest.mark.parametrize("hw", [1, 2, 16, 32, 128])
@pytest.mark.parametrize("transpose", [False, True])
def test_plain_mode_equals_jax(hw, transpose):
    """Plain mode on a strided hi slice (row stride ld > hw), n no multiple
    of 8, output padded to n_out rows that must be zero."""
    rng = np.random.default_rng(hw)
    n, ld = 37, hw + 8
    table = words(rng, n, ld)
    view = torch.from_numpy(table)[:, ld - hw:]
    assert view.stride(0) == ld
    got = expand_bits(view, n_out=64, transpose=transpose)
    assert got.dtype == torch.int8
    got = got.numpy().T if transpose else got.numpy()
    want = jax_bits(table[:, ld - hw:])
    assert got.shape == (64, 32 * hw)
    assert np.array_equal(got[:n], want) and not got[n:].any()
    assert np.array_equal(
        want, np.unpackbits(np.ascontiguousarray(table[:, ld - hw:]).view(
            np.uint8), axis=1, bitorder="little"))


def test_hubcore_expand_bits_is_x():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(words(rng, 40, 4))
    assert torch.equal(hubcore._expand_bits(x, 128), expand_bits(x))
    assert torch.equal(hubcore._expand_bits(x, 128, transpose=True),
                       expand_bits(x, transpose=True))
    with pytest.raises(ValueError, match="cpad"):
        hubcore._expand_bits(x, 96)


def gather_reference(base, r, tab, cols):
    """The JAX clique engines' gather-AND (cliquebig._chain_hi_bilinear's
    masks) in numpy: base[r] & tab[c0] & ..., zero where any id is out of
    its table."""
    ok = (r >= 0) & (r < base.shape[0])
    y = base[np.where(ok, r, 0)]
    for j in range(cols.shape[1]):
        cj = cols[:, j]
        okj = ok & (cj >= 0) & (cj < tab.shape[0])
        y = y & tab[np.where(okj, cj, 0)]
        ok = okj
    return np.where(ok[:, None], y, 0)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("transpose", [False, True])
def test_gathered_mode_equals_jax(depth, transpose):
    """Explicit rows r and depth tab ids, SENTINEL and out-of-range ids in
    both, against JAX's _expand_bits of the masked gather-AND."""
    rng = np.random.default_rng(10 + depth)
    hw, nb, nt, n = 16, 50, 70, 203
    base, tab = words(rng, nb, hw + 4), words(rng, nt, hw)
    r = rng.integers(-3, nb + 3, n).astype(np.int32)
    cols = rng.integers(-2, nt + 2, (n, depth)).astype(np.int32)
    r[::11] = SENTINEL
    if depth:
        cols[5::13, depth - 1] = SENTINEL
    t = torch.from_numpy
    got = expand_bits(t(base)[:, 4:], r=t(r), tab=t(tab), cols=t(cols),
                      n_out=224, transpose=transpose).numpy()
    got = got.T if transpose else got
    want = jax_bits(gather_reference(base[:, 4:], r, tab, cols))
    assert np.array_equal(got[:n], want) and not got[n:].any()
    assert want.any()


def test_row_div_mode_is_bucket_expansion():
    """Explicit rows r = slot // slots at depth 1 (the bucket form that
    scripts/prof_breakdown.py --clique times) give JAX's expansion of each
    _bucket_tris bucket (y2rows[:, None] & core_hi[cmat], SENTINEL slots
    zero, as in _tri_stream_bilinear); and the flat, edge-sorted triangle
    list that CliqueKEngine expands gives the same rows, one a task."""
    rng = np.random.default_rng(4)
    n_e, hw, c = 24, 2, 40
    y2 = words(rng, n_e, hw)
    core_hi = words(rng, c, hw)
    tri = np.concatenate([
        np.stack([np.full(m, e), np.sort(rng.choice(c, m, replace=False))],
                 axis=1)
        for e, m in enumerate(rng.integers(0, 20, n_e))]).astype(np.int32)
    t = torch.from_numpy
    slot_rows = []
    buckets = cliquek._bucket_tris(y2, tri, classes=(2, 8))
    assert len(buckets) == 2
    for rows, cm, _step, _rt in buckets:
        tcl = cm.shape[1]
        r = np.arange(cm.size, dtype=np.int32) // tcl
        got = expand_bits(t(rows), r=t(r), tab=t(core_hi),
                          cols=t(cm).reshape(-1, 1),
                          n_out=-(-cm.size // 32) * 32,
                          transpose=True).numpy().T
        ok = (cm >= 0) & (cm < c)
        y = np.where(ok[:, :, None],
                     rows[:, None, :] & core_hi[np.where(ok, cm, 0)], 0)
        want = jax_bits(y.reshape(-1, hw))
        assert np.array_equal(got[:cm.size], want) and \
            not got[cm.size:].any()
        slot_rows.append(want[ok.reshape(-1)])
    flat = expand_bits(t(y2), r=t(np.ascontiguousarray(tri[:, 0])),
                       tab=t(core_hi), cols=t(np.ascontiguousarray(
                           tri[:, 1:]))).numpy()
    slots = np.concatenate(slot_rows)
    assert flat.shape == slots.shape == (tri.shape[0], 32 * hw)
    assert np.array_equal(np.unique(flat, axis=0, return_counts=True)[1],
                          np.unique(slots, axis=0, return_counts=True)[1])
    assert np.array_equal(np.unique(flat, axis=0), np.unique(slots, axis=0))


def test_argument_checks():
    x = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        expand_bits(x.long())
    with pytest.raises(ValueError, match="n_out"):
        expand_bits(x, n_out=4)
    with pytest.raises(ValueError, match="cols"):
        expand_bits(x, cols=torch.zeros((8, 7), dtype=torch.int32), tab=x)
    with pytest.raises(ValueError, match="tab"):
        expand_bits(x, cols=torch.zeros((8, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="r "):
        expand_bits(x, r=torch.zeros(7, dtype=torch.int32), tab=x,
                    cols=torch.zeros((8, 1), dtype=torch.int32))
    assert expand_bits_plain(x[:0]).shape == (0, 64)
    assert expand_bits_plain(x[:0], n_out=32, transpose=True).shape == \
        (64, 32)


@pytest.mark.parametrize("seed,n,words_,n_bits,n_src", [
    (0, 200, 8, 256, 2), (1, 64, 8, 100, 3), (2, 500, 16, 512, 2),
    (3, 10, 8, 1, 2)])
def test_expand_emit_equals_jax_bridge(seed, n, words_, n_bits, n_src):
    """The port bridge's expand_emit against the JAX bridge's on random
    bitmaps (bit 31 set), whole and resumed under a small cap."""
    rng = np.random.default_rng(seed)
    v = 50
    bases = [words(rng, v, words_) for _ in range(n_src)]
    rows = [rng.integers(0, v, n).astype(np.int32) for _ in range(n_src)]
    attrs = [np.arange(n, dtype=np.int32),
             rng.integers(0, 1000, n).astype(np.int32)]
    # whole, and resumed over about 8 calls (a task emits <= n_bits)
    for cap in (n * n_bits + 1, max(n_bits, n * n_bits // 64)):
        outs = []
        for bridge in (native_bridge, jbridge):
            out = np.zeros((cap, 3), np.int32)
            got, start = [], 0
            while start < n:
                n_em, nxt = bridge.expand_emit(bases, rows, attrs, words_,
                                               n_bits, start, cap, out)
                assert nxt > start
                got.append(out[:n_em].copy())
                start = nxt
            outs.append(np.concatenate(got))
        assert np.array_equal(outs[0], outs[1]) and outs[0].shape[0] > 0
