"""Kernel Q (graphminer_tpu_torch/ops/cuda_cliquebig.py, the compaction of
graphminer_tpu/ops/cliquebig.py::_tri_expand_bilinear) on the CPU: the
plain versions of its count and emit against numpy references and the
native count_multi (bit 31 set, n_bits inside a word, tasks whose ids lie
outside their tables, tasks with no bit, offsets past 2^31 given as int64,
an empty chunk); a numpy model of the emit kernel's tiles and staging
rounds; the engine's chunks cut from the device offsets against the host
offsets they replaced; and Q's quads through kernel G's plain version
against the JAX function's partials. All exact."""
from unittest import mock

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import cliquebig as jcb
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cliquebig
from graphminer_tpu_torch.ops.cuda_cliquebig import (QUAD_STAGE, QUAD_TILE,
                                                     quad_count,
                                                     quad_count_plain,
                                                     quad_emit,
                                                     quad_emit_plain,
                                                     quad_offsets)
from graphminer_tpu_torch.ops.cuda_gram import bit_gram_plain

SENTINEL = np.iinfo(np.int32).max
t = torch.from_numpy


def words(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def inputs(rng, words_, n_bits, e=300, c=200, n=700):
    y2 = words(rng, (e, words_)) & words(rng, (e, words_))
    core = words(rng, (c, words_))
    core[7] = 0                                   # tasks with no bit
    y2[:, 0] |= np.int32(-2**31)                  # bit 31 in every row
    erow = rng.integers(-2, e + 2, n).astype(np.int32)
    c1 = rng.integers(-2, c + 2, n).astype(np.int32)
    erow[::37] = SENTINEL
    c1[5::11] = 7
    return y2, core, erow, c1


def task_bits(y2, core, r, c, n_bits):
    """The set bits below n_bits of y2[r] & core[c], ascending (none for
    an id outside its table)."""
    if not (0 <= r < y2.shape[0] and 0 <= c < core.shape[0]):
        return []
    y = (y2[r] & core[c]).view(np.uint32)
    return [b for b in range(min(n_bits, 32 * y.shape[0]))
            if (int(y[b // 32]) >> (b % 32)) & 1]


def reference(y2, core, erow, c1, n_bits):
    return [task_bits(y2, core, r, c, n_bits) for r, c in zip(erow, c1)]


def np_offsets(counts):
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, dtype=np.int64, out=off[1:])
    return off


@pytest.mark.parametrize("words_,n_bits", [(8, 256), (8, 200), (3, 65),
                                           (32, 1000)])
def test_quad_emit_plain_equals_numpy(words_, n_bits):
    rng = np.random.default_rng(words_ + n_bits)
    y2, core, erow, c1 = inputs(rng, words_, n_bits)
    ref = reference(y2, core, erow, c1, n_bits)
    counts = np.array([len(b) for b in ref])
    base = (1 << 31) + 12345                      # a slice of a long scan
    off = quad_offsets(t(counts)) + base
    assert off.dtype == torch.int64
    r, cols = quad_emit_plain(t(y2), t(core), t(erow), t(c1), off, n_bits)
    want_r = np.repeat(erow, counts)
    want_c = np.stack([np.repeat(c1, counts),
                       np.concatenate([np.array(b, np.int64) for b in ref])],
                      axis=1)
    assert r.dtype == cols.dtype == torch.int32
    assert np.array_equal(r.numpy(), want_r)
    assert np.array_equal(cols.numpy(), want_c)
    assert (counts == 0).sum() > 20 and counts.max() > 0
    if n_bits % 32 == 0:
        assert (want_c[:, 1] % 32 == 31).any()    # bit 31 emitted
    # the CPU wrapper takes the plain version; n_quads from off
    r2, c2 = quad_emit(t(y2), t(core), t(erow), t(c1), off, n_bits)
    assert torch.equal(r2, r) and torch.equal(c2, cols)


def test_offsets_equal_count_multi():
    """quad_offsets over the native count_multi counts of the engine's
    triangle tasks (y2 rows as bm[a] & bm[b]) is Q's off, and equals the
    scan of quad_count's counts."""
    rng = np.random.default_rng(3)
    bm = words(rng, (400, 8))
    core = bm[200:]
    ea, eb = rng.integers(0, 400, (2, 300)).astype(np.int32)
    y2 = bm[ea] & bm[eb]
    erow = rng.integers(0, 300, 900).astype(np.int32)
    c1 = rng.integers(0, 200, 900).astype(np.int32)
    counts = native_bridge.count_multi([bm, bm, core],
                                       [ea[erow], eb[erow], c1], 8, 200)
    ref = reference(y2, core, erow, c1, 200)
    assert np.array_equal(counts, [len(b) for b in ref])
    off = quad_offsets(t(counts))
    assert off.dtype == torch.int64 and int(off[0]) == 0
    assert int(off[-1]) == counts.sum()
    assert torch.equal(off, quad_offsets(quad_count(t(y2), t(core), t(erow),
                                                    t(c1), 200)))
    r, cols = quad_emit(t(y2), t(core), t(erow), t(c1), off, 200,
                        int(off[-1]))
    assert r.shape == (counts.sum(),) and cols.shape == (counts.sum(), 2)


@pytest.mark.parametrize("words_,n_bits", [(8, 256), (8, 200), (3, 65),
                                           (32, 1000), (128, 4096),
                                           (128, 4001), (5, 129)])
def test_quad_count_plain_equals_numpy_and_count_multi(words_, n_bits):
    """quad_count (the CPU wrapper, so its plain version) == the numpy
    reference over every task, bit 31 set in every y2 row and ids outside
    their tables counting 0, and == the native count_multi on the valid
    tasks (which it reads as bm[a] & bm[b] & core[c1])."""
    rng = np.random.default_rng(10 * words_ + n_bits)
    y2, core, erow, c1 = inputs(rng, words_, n_bits)
    got = quad_count(t(y2), t(core), t(erow), t(c1), n_bits)
    assert got.dtype == torch.int32
    assert torch.equal(got, quad_count_plain(t(y2), t(core), t(erow), t(c1),
                                             n_bits))
    want = [len(b) for b in reference(y2, core, erow, c1, n_bits)]
    assert got.tolist() == want
    ok = (erow >= 0) & (erow < y2.shape[0]) & (c1 >= 0) & \
        (c1 < core.shape[0])
    assert (~ok).sum() > 20 and got[t(~ok)].eq(0).all()
    cm = native_bridge.count_multi([y2, core], [erow[ok], c1[ok]], words_,
                                   n_bits)
    assert np.array_equal(cm, got.numpy()[ok])
    assert quad_count(t(y2), t(core), t(erow[:0]), t(c1[:0]),
                      n_bits).shape == (0,)


def test_empty_and_checks():
    rng = np.random.default_rng(5)
    y2, core, erow, c1 = inputs(rng, 8, 256, n=4)
    before = quad_emit.launches
    r, cols = quad_emit(t(y2), t(core), t(erow[:0]), t(c1[:0]),
                        t(np.zeros(1, np.int64)), 256)
    assert r.shape == (0,) and cols.shape == (0, 2)
    assert quad_emit.launches == before
    with pytest.raises(TypeError):
        quad_emit(t(y2), t(core), t(erow), t(c1), t(np.zeros(5, np.int32)),
                  256)
    with pytest.raises(ValueError):
        quad_emit(t(y2), t(core), t(erow), t(c1), t(np.zeros(4, np.int64)),
                  256)
    with pytest.raises(ValueError):
        quad_emit(t(y2), t(core[:, :4]), t(erow), t(c1),
                  t(np.zeros(5, np.int64)), 256)
    with pytest.raises(TypeError):
        quad_count(t(y2), t(core), t(erow.astype(np.int64)), t(c1), 256)
    with pytest.raises(ValueError):
        quad_count(t(y2), t(core), t(erow), t(c1[:2]), 256)
    with pytest.raises(ValueError):
        quad_count(t(y2), t(core), t(erow), t(c1), -1)


# --------------------------------------------------------------------------
# a numpy model of the emit kernel's tiles and staging rounds
# --------------------------------------------------------------------------

UNWRITTEN = np.uint32(0xFFFFFFFF)


def run_window(y2, core, rows, cols, on, acc, n_bits, visit):
    """csrc/quad_emit.cu::run_window for one warp's 32 tasks (lists rows,
    cols, on, acc): a run is every pending task of one row, in lane order;
    per slab of 128 words, the row's non-zero 4-word groups (G),
    segments of P lanes (G rounded up to a power of two), 32 // P member
    tasks a step; visit(task, x words, first word, slot) for a lane with
    bits, slot = the task's acc + its bits in earlier groups of the slab;
    then acc += the task's bits of the step."""
    nw = min(y2.shape[1], -(-n_bits // 32))
    vec = 4
    sw = 32 * vec
    mask = np.array([min(max(n_bits - 32 * w, 0), 32)
                     for w in range(y2.shape[1])])
    mask = ((np.uint64(1) << mask.astype(np.uint64)) - np.uint64(1)
            ).astype(np.uint32)
    todo = [i for i in range(32) if on[i]]
    while todo:
        r = rows[todo[0]]
        members = [i for i in todo if rows[i] == r]
        todo = [i for i in todo if rows[i] != r]
        y = y2[r].view(np.uint32) & mask       # a group may pass nw
        for s0 in range(0, nw, sw):
            groups = [g for g in range(s0, min(s0 + sw, nw), vec)
                      if y[g:g + vec].any()]
            if not groups:
                continue
            p = 1
            while p < len(groups):
                p *= 2
            per = 32 // p
            for base in range(0, len(members), per):
                for m in members[base:base + per]:
                    rank = 0
                    for g in groups:
                        x = y[g:g + vec] & \
                            core[cols[m], g:g + vec].view(np.uint32)
                        cnt = sum(bin(int(v)).count("1") for v in x)
                        if cnt:
                            visit(m, x, g, acc[m] + rank)
                        rank += cnt
                    acc[m] += rank


def emulate_emit(y2, core, erow, c1, off, n_bits, tile=QUAD_TILE,
                 stage=QUAD_STAGE):
    """csrc/quad_emit.cu's emit, step by step: a tile of `tile` tasks a
    block, 32 a warp (run_window); rounds of `stage` output slots from the
    tile's first slot rounded down to 4; a quad staged as (task-local
    index << 24 | c2) at its slot, if the slot lies in the round and in
    its task's range; the round written in groups of 4 slots, a full group
    as one 16-byte store (so its first output index must be a multiple of
    4) and a partial one slot by slot. Returns (r_out, cols_out, rounds a
    tile)."""
    n = erow.shape[0]
    first = int(off[0])
    nq = int(off[-1]) - first
    r_out = np.full(nq, -1, np.int64)
    cols_out = np.full((nq, 2), -1, np.int64)
    rounds = []
    for t0 in range(0, n, tile):
        nt = min(tile, n - t0)
        s_off = [int(v) - first for v in off[t0:t0 + nt + 1]]
        s_r, s_c = erow[t0:t0 + nt], c1[t0:t0 + nt]
        lo, hi = s_off[0], s_off[nt]
        n_rounds = 0
        r0 = lo & ~3
        while r0 < hi:
            n_rounds += 1
            r1 = r0 + stage
            buf = np.full(stage, UNWRITTEN, np.uint32)
            for u0 in range(0, nt, 32):
                us = range(u0, min(nt, u0 + 32))
                rows = [s_r[u] for u in us] + [-1] * (32 - len(us))
                cols = [s_c[u] for u in us] + [-1] * (32 - len(us))
                on = [s_off[u] < s_off[u + 1] and s_off[u + 1] > r0 and
                      s_off[u] < r1 and 0 <= s_r[u] < y2.shape[0] and
                      0 <= s_c[u] < core.shape[0] for u in us]
                on += [False] * (32 - len(us))
                acc = [s_off[u] for u in us] + [0] * (32 - len(us))

                def visit(m, x, g, p):
                    u = u0 + m
                    bits = np.nonzero(np.unpackbits(
                        x.view(np.uint8), bitorder="little"))[0]
                    for c2 in 32 * g + bits:
                        if r0 <= p < r1 and p < s_off[u + 1]:
                            buf[p - r0] = (u << 24) | int(c2)
                        p += 1
                run_window(y2, core, rows, cols, on, acc, n_bits, visit)
                for i, u in enumerate(us):
                    assert not on[i] or acc[i] == s_off[u + 1]
            ia, ib = max(r0, lo) - r0, min(r1, hi) - r0
            for g in range(ia >> 2, (ib + 3) >> 2):
                i0 = 4 * g
                full = i0 >= ia and i0 + 4 <= ib
                assert not full or (r0 + i0) % 4 == 0
                for i in range(max(i0, ia), min(i0 + 4, ib)):
                    q = buf[i]
                    assert q != UNWRITTEN
                    r_out[r0 + i] = s_r[q >> 24]
                    cols_out[r0 + i] = (s_c[q >> 24], q & 0xFFFFFF)
            r0 += stage
        rounds.append(n_rounds)
    return r_out, cols_out, rounds


def emit_case(rng):
    """128-word rows (n_bits 4096): a first tile whose tasks have no quad,
    runs of equal erow that cross tile boundaries, tasks of 4096 quads
    (every bit) at unaligned offsets, then unsorted erow with ids outside
    their tables."""
    w, e, c = 128, 400, 300
    y2 = words(rng, (e, w)) & words(rng, (e, w)) & words(rng, (e, w))
    core = words(rng, (c, w))
    y2[0], core[0] = -1, -1                       # 4096 quads
    y2[1] = 0                                     # no quad
    n = 6 * QUAD_TILE + 77
    erow = rng.integers(-1, e + 1, n).astype(np.int32)
    c1 = rng.integers(-1, c + 1, n).astype(np.int32)
    erow[:QUAD_TILE] = 1
    runs = np.repeat(rng.integers(2, e, 20), 25)   # runs of 25 tasks
    erow[QUAD_TILE:QUAD_TILE + runs.size] = runs
    for i in (QUAD_TILE + 3, 3 * QUAD_TILE - 1, 3 * QUAD_TILE, 4 * QUAD_TILE
              + 9, 4 * QUAD_TILE + 10):
        erow[i], c1[i] = 0, 0
    return y2, core, erow, c1, 32 * w


def test_emulated_emit_equals_plain():
    """The numpy model of the emit's tiling and staging rounds writes what
    quad_emit_plain writes, and the case exercises what it should: a
    round-free tile, tiles of several rounds, 4096-quad tasks, a tile
    boundary inside an erow run, offsets that are not multiples of 4."""
    rng = np.random.default_rng(11)
    y2, core, erow, c1, n_bits = emit_case(rng)
    counts = quad_count(t(y2), t(core), t(erow), t(c1), n_bits)
    assert int(counts[:QUAD_TILE].sum()) == 0
    assert int(counts.max()) == n_bits
    off = quad_offsets(counts) + ((1 << 31) + 5)
    r, cols = quad_emit_plain(t(y2), t(core), t(erow), t(c1), off, n_bits)
    er, ec, rounds = emulate_emit(y2, core, erow, c1, off.numpy(), n_bits)
    assert np.array_equal(er, r.numpy()) and np.array_equal(ec, cols.numpy())
    assert rounds[0] == 0 and max(rounds) >= 3
    assert erow[QUAD_TILE * 2 - 1] == erow[QUAD_TILE * 2]
    assert (off.numpy()[::QUAD_TILE] % 4 != 0).any()


@pytest.mark.parametrize("words_,n_bits", [(8, 250), (128, 4000),
                                           (160, 5100)])
def test_emulated_emit_small_stage_and_tile(words_, n_bits):
    """The same model with a 64-slot stage and 16-task tiles (a warp's
    window half full) on random rows: many rounds a tile, tasks split
    across rounds, rows of one slab and of several (160 words), still the
    plain version's output."""
    rng = np.random.default_rng(12 + words_)
    y2, core, erow, c1 = inputs(rng, words_, n_bits, n=300)
    erow[100:200] = np.sort(erow[100:200])        # runs of equal erow
    counts = quad_count(t(y2), t(core), t(erow), t(c1), n_bits)
    off = quad_offsets(counts) + 3
    r, cols = quad_emit_plain(t(y2), t(core), t(erow), t(c1), off, n_bits)
    er, ec, rounds = emulate_emit(y2, core, erow, c1, off.numpy(), n_bits,
                                  tile=16, stage=64)
    assert np.array_equal(er, r.numpy()) and np.array_equal(ec, cols.numpy())
    assert max(rounds) > 4


# --------------------------------------------------------------------------
# the engine's chunks from the device offsets
# --------------------------------------------------------------------------

def host_chunks(off: np.ndarray, t6: int, cap6: int):
    """The chunks as the engine cut them from host offsets before Q's
    count ran on the card: the largest e with quads <= cap6 and
    e - b <= t6, at least one task."""
    out, b, n = [], 0, off.shape[0] - 1
    while b < n:
        e = int(np.searchsorted(off, off[b] + cap6, side="right")) - 1
        e = min(max(e, b + 1), b + t6, n)
        out.append((b, e, int(off[e] - off[b])))
        b = e
    return out


@pytest.mark.parametrize("t6,cap6", [(1 << 10, 4096), (1 << 12, 1 << 16),
                                     (1 << 22, 1 << 26)])
def test_device_offsets_chunker(t6, cap6):
    """With CAP6 and T6 small, the chunks cut from the device offsets hold
    at most T6 tasks and CAP6 quads each, cover the triangle tasks once
    and in order, are the host offsets' chunks, and their quads,
    concatenated, are those the host offsets (count_multi, as the engine
    took them) give."""
    eng = cliquebig.CliqueBigEngine(rmat(12, 8, seed=23), 6, device="cpu")
    eng.T6, eng.CAP6 = t6, cap6
    chunks = list(eng.quad_chunks())
    tris = np.concatenate([st[:, 2:4].copy()
                           for st in eng._stream(1, eng.c, 3)])
    terow, tc1 = tris[:, 0].copy(), tris[:, 1].copy()
    counts = native_bridge.count_multi(
        [eng.bm_np, eng.bm_np, eng.core_np],
        [eng.ea[terow], eng.eb[terow], tc1], eng.words, eng.c)
    off = np_offsets(counts)
    assert eng.n_tri_tasks == tris.shape[0] > 10_000
    assert eng.n_hi_tasks == int(off[-1])
    assert [(int(ch[2].numel()), ch[6]) for ch in chunks] == \
        [(e - b, q) for b, e, q in host_chunks(off, t6, cap6)]
    assert len(chunks) > (3 if t6 < (1 << 20) else 0)
    for ch in chunks:
        assert ch[2].numel() <= t6 and (ch[6] <= cap6 or ch[2].numel() == 1)
        assert int(ch[4][-1] - ch[4][0]) == ch[6]
    assert np.array_equal(torch.cat([ch[2] for ch in chunks]).numpy(), terow)
    assert np.array_equal(torch.cat([ch[3] for ch in chunks]).numpy(), tc1)
    got = [quad_emit(*ch) for ch in chunks]
    y2full = chunks[0][0]
    r, cols = quad_emit_plain(y2full, eng.core, t(terow), t(tc1), t(off),
                              eng.c)
    assert torch.equal(torch.cat([g[0] for g in got]), r)
    assert torch.equal(torch.cat([g[1] for g in got]), cols)


def test_chunk_bounds_edges():
    """chunk_bounds on hand-made offsets: zero-count tasks join the chunk
    before them while it has room, a task above max_quads is a chunk of its
    own, no task gives no chunk."""
    cnt = torch.tensor([0, 3, 0, 0, 9, 2, 2, 0, 5, 0], dtype=torch.int32)
    off = quad_offsets(cnt)
    assert cliquebig.chunk_bounds(off, 100, 4) == \
        [(0, 4, 3), (4, 5, 9), (5, 8, 4), (8, 9, 5), (9, 10, 0)]
    assert cliquebig.chunk_bounds(off, 3, 100) == \
        [(0, 3, 3), (3, 6, 11), (6, 9, 7), (9, 10, 0)]
    assert cliquebig.chunk_bounds(off[:1], 3, 100) == []
    assert cliquebig.chunk_bounds(off, 100, 4) == \
        host_chunks(off.numpy(), 100, 4)


def test_count_multi_runs_once_on_the_device_path():
    """On the k = 6 device path count_multi runs once, for the DEV6_MIN_TRIS
    estimate, and not for Q's offsets (quad_count does them); the count
    is the host path's."""
    g = rmat(11, 8, seed=23)
    eng = cliquebig.CliqueBigEngine(g, 6, device="cpu")
    want = eng.count()
    assert eng.path == "host"
    real = native_bridge.count_multi
    with mock.patch.object(native_bridge, "count_multi",
                           side_effect=real) as cm:
        eng.DEV6_MIN_TRIS = 0
        assert eng.count() == want and eng.path == "device"
        assert cm.call_count == 1
        assert cm.call_args.args[1][0] is eng.ea
    assert set(eng.stream_s) >= {"hi", "lo", "hi_estimate", "hi_triangles",
                                 "hi_h2d", "hi_offsets", "hi_quad_gram"}


# --------------------------------------------------------------------------
# against JAX
# --------------------------------------------------------------------------

def test_quads_through_gram_equal_jax_tri_expand_bilinear():
    """Q's quads of the engine's triangle tasks, through kernel G's plain
    version at depth 2, sum to JAX's _tri_expand_bilinear partials (lo +
    hi * 2^16) on the same tasks (SENTINEL-padded to a slab), exactly."""
    g = rmat(11, 8, seed=29)
    eng = cliquebig.CliqueBigEngine(g, 6, core=512, hi=64, device="cpu")
    ref = jcb.CliqueBigEngine(JHostGraph(rowptr=g.rowptr, colidx=g.colidx,
                                         is_dag=g.is_dag), 6, core=512, hi=64)
    chunks = list(eng.quad_chunks())
    assert len(chunks) == 1
    y2full, core, erow, c1, off, n_bits, nq = chunks[0]
    assert nq > 10_000
    r, cols = quad_emit(*chunks[0])
    got = bit_gram_plain(eng.y2hi, eng.hi_mask, r=r, tab=eng.core_hi,
                         cols=cols)
    slab = 4096
    n = erow.numel()
    pad = -n % slab
    jr = np.concatenate([erow.numpy(), np.full(pad, SENTINEL)]
                        ).astype(np.int32)
    jc = np.concatenate([c1.numpy(), np.full(pad, SENTINEL)]
                        ).astype(np.int32)
    jy2 = (ref.bm_np[ref.ea] & ref.bm_np[ref.eb]).view(np.int32)
    assert np.array_equal(jy2, y2full.numpy())
    lohi = np.asarray(jcb._tri_expand_bilinear(
        jy2, ref.core_dev, ref.y2hi, ref.core_hi, ref.bhh, jr, jc,
        words=ref.words, hi_words=ref.hi_words, slab=slab,
        cap=nq + (-nq % slab), cdim=ref.words * 32), dtype=np.int64)
    assert int(got.sum()) == int(lohi[:, 0].sum() + (lohi[:, 1].sum() << 16))
    assert int(got.sum()) > 0


def test_quad_bounds_count_their_bytes():
    """quad_bytes (the emit) and quad_count_bytes (the count): the tasks'
    ids (and the emit's offsets, 8 B), the count's 4 B a task, each
    distinct y2 and core row a valid task names read once at the table's
    width, and the emit's 12 B a quad; bound_ms over 3.35 TB/s."""
    from graphminer_tpu_torch.utils.profiling import (bound_ms, quad_bytes,
                                                      quad_count_bytes)
    rng = np.random.default_rng(21)
    y2, core, erow, c1 = inputs(rng, 8, 256, e=50, c=40, n=3000)
    ok = (erow >= 0) & (erow < 50) & (c1 >= 0) & (c1 < 40)
    rows = np.unique(erow[ok]).size + np.unique(c1[ok]).size
    assert rows == 90                             # each row once, not a task
    args = (t(y2), t(core), t(erow), t(c1))
    assert quad_count_bytes(*args) == 12 * 3000 + rows * 8 * 4
    assert quad_bytes(*args, 777) == 16 * 3000 + rows * 8 * 4 + 12 * 777
    ms, by = bound_ms(quad_count_bytes(*args))
    assert by == "bytes" and ms == quad_count_bytes(*args) / 3.35e12 * 1e3
