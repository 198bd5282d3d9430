"""Port window probe (graphminer_tpu_torch/scripts/prof_window.py and
ops/cuda_window.py, kernels m3/m3b via their plain version on the CPU)
against scripts/prof_window.py. That script parses sys.argv and builds its
arrays at import, so it is loaded by importlib under a patched argv
(T=4096, CAP=512, SPAN=256, W). The port's m3 is held against the JAX m3
Pallas kernel in TPU interpret mode and against m1; the port's m3b against
JAX m1 and m3, as the script itself asserts (its m3b applies pl.ds to an
array and cannot be traced in interpret mode). All exact.

The JAX package switches x64 on when it is imported, and the script's
variants trace only with it off (it is run on its own, without the
package), so they are called under jax.enable_x64(False); the package is
imported here so that the state does not depend on which test file a
worker ran before."""
import functools
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import graphminer_tpu  # noqa: F401  (switches x64 on, see above)
from graphminer_tpu_torch.ops import cuda_window
from graphminer_tpu_torch.scripts import prof_window

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "prof_window.py")
ARGS = (4096, 512, 256)          # T, CAP, SPAN
#: m1 totals at these sizes (the port's and the JAX script's alike)
TOTALS = {8: 253_956, 128: 4_058_453}


@functools.lru_cache(maxsize=None)
def jax_script(w):
    """scripts/prof_window.py imported with argv T CAP SPAN W."""
    argv = sys.argv
    sys.argv = ["prof_window", *map(str, ARGS), str(w)]
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_prof_window_w{w}", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def jcall(fn, *args):
    """fn(*args) as a numpy array, traced and run with x64 off."""
    with jax.enable_x64(False):
        return np.asarray(fn(*args))


def port_inputs(w):
    table, starts, lidx, src = prof_window.make_inputs(*ARGS, w)
    return tuple(torch.from_numpy(a) for a in (src, table, starts, lidx))


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call

    @functools.wraps(real)
    def pallas_call(*args, **kwargs):
        kwargs.setdefault("interpret", pltpu.InterpretParams())
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)


@pytest.mark.parametrize("w", [8, 128])
def test_inputs_equal(w):
    jm = jax_script(w)
    table, starts, lidx, src = prof_window.make_inputs(*ARGS, w)
    assert np.array_equal(table, jm.table_h)
    assert np.array_equal(starts, jm.starts_h)
    assert np.array_equal(lidx, jm.lidx_h)
    assert np.array_equal(src.reshape(-1, w), jm.src_h)


@pytest.mark.parametrize("w", [8, 128])
def test_m3_matches_jax_m3_and_m1(interpret, w):
    jm = jax_script(w)
    args = (jm.src_stream, jm.starts, jm.lidx)
    want_m1 = jcall(jm.m1, *args)
    want_m3 = jcall(jm.m3(jm.nchunks), *args)
    got = cuda_window.window_count(*port_inputs(w), span=ARGS[2],
                                   rows_per_step=1)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_m3)
    assert np.array_equal(got.numpy(), want_m1)
    assert int(got.sum()) == TOTALS[w]


@pytest.mark.parametrize("w", [8, 128])
def test_m3b_matches_jax_m1(w):
    jm = jax_script(w)
    want = jcall(jm.m1, jm.src_stream, jm.starts, jm.lidx)
    got = cuda_window.window_count(*port_inputs(w), span=ARGS[2],
                                   rows_per_step=8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [8, 128])
def test_port_variants_match_jax(w):
    """The port's plain m0, m1 and m2 equal the JAX script's."""
    jm = jax_script(w)
    jargs = (jm.src_stream, jm.starts, jm.lidx)
    src, table, starts, lidx = port_inputs(w)
    for name in ("m0", "m1", "m2"):
        got = getattr(prof_window, name)(src, starts, lidx, table, ARGS[2])
        want = jcall(getattr(jm, name), *jargs).astype(np.int64)
        assert np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("w", [8, 128])
def test_script_main_on_cpu(w, capsys):
    res = prof_window.main([*map(str, ARGS), str(w), "--device", "cpu"])
    assert {res[k]["total"] for k in ("m1", "m2", "m3", "m3b")} == {TOTALS[w]}
    assert "m3b" in capsys.readouterr().out


def test_out_of_range_start_and_index():
    """Starts clamp to [0, ND - span] like dynamic_slice; a local index
    outside [0, span) adds nothing."""
    rng = np.random.default_rng(2)
    table = rng.integers(0, 1 << 31, size=(40, 8), dtype=np.int64
                         ).astype(np.int32)
    src = rng.integers(0, 1 << 31, size=(3, 5, 8), dtype=np.int64
                       ).astype(np.int32)
    starts = np.array([-7, 35, 10], dtype=np.int32)
    lidx = np.array([[0, 1, 9, 10, -1]] * 3, dtype=np.int32)
    got = cuda_window.window_count(
        *(torch.from_numpy(a) for a in (src, table, starts, lidx)), span=10,
        rows_per_step=1)
    want = []
    for c, st in enumerate([0, 30, 10]):
        rows = table[st + lidx[c, :3]]
        want.append(int(np.bitwise_count(src[c, :3] & rows).sum()))
    assert got.tolist() == want


def test_window_rejects_bad_args():
    src = torch.zeros((2, 4, 8), dtype=torch.int32)
    table = torch.zeros((16, 8), dtype=torch.int32)
    st = torch.zeros(2, dtype=torch.int32)
    li = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_per_step"):
        cuda_window.window_count(src, table, st, li, span=4, rows_per_step=2)
    with pytest.raises(ValueError, match="span"):
        cuda_window.window_count(src, table, st, li, span=17, rows_per_step=1)


def emulate_kernel(src, table, starts, lidx, span, rows_per_step, wave):
    """Kernels m3 and m3b (csrc/window_count.cu::window_count_kernel, the
    window read through L2) in numpy: the launch's grid
    (cuda_window.grid_blocks over one wave of `wave` blocks), block b
    taking tasks [n*b/nb, n*(b+1)/nb) of the n = nck * cap tasks, chunk by
    chunk; in each chunk, thread slot s of the per_pass = BLOCK / (w / 4)
    lane groups takes tasks t_lo + s, stepping per_pass * ROWS, ROWS of them
    per_pass apart a step, none past t_hi. Checks that every task is counted
    exactly once; int64 sums per chunk, int32 at the end (the last block's
    finish)."""
    nck, cap, w = src.shape
    nd = table.shape[0]
    n = nck * cap
    nb = cuda_window.grid_blocks(n, w, wave)
    per_pass = cuda_window.BLOCK // (w // 4)
    sums = np.zeros(nck, np.int64)
    covered = np.zeros(n, np.int64)
    for b in range(nb):
        lo, hi = n * b // nb, n * (b + 1) // nb
        c = lo // cap
        while c < nck and c * cap < hi:
            t_lo, t_hi = max(lo - c * cap, 0), min(hi - c * cap, cap)
            taken = [t0 + j * per_pass
                     for s in range(per_pass)
                     for t0 in range(t_lo + s, t_hi, per_pass * rows_per_step)
                     for j in range(rows_per_step)
                     if t0 + j * per_pass < t_hi]
            t = np.array(taken, np.int64)
            np.add.at(covered, c * cap + t, 1)
            st = min(max(int(starts[c]), 0), nd - span)
            li = lidx[c, t]
            ok = (li >= 0) & (li < span)
            rows = table[st + np.where(ok, li, 0)]
            pc = np.bitwise_count(src[c, t].view(np.uint32)
                                  & rows.view(np.uint32)).sum(axis=1)
            sums[c] += int((pc * ok).sum())
            c += 1
    assert (covered == 1).all()
    assert (sums < 1 << 31).all()
    return sums.astype(np.int32)


@pytest.mark.parametrize("w", [8, 128])
@pytest.mark.parametrize("rows_per_step", [1, 8])
def test_emulated_kernels_match_jax_m3_and_m1(interpret, w, rows_per_step):
    """m3/m3b's kernel, emulated, against the JAX m3 (Pallas, interpret
    mode) and m1: the script's 8 chunks over grids of 3 and 5 blocks (no
    multiple of the wave, so blocks start and end inside chunks) and over
    a full H100 wave."""
    jm = jax_script(w)
    args = (jm.src_stream, jm.starts, jm.lidx)
    want_m1 = jcall(jm.m1, *args)
    want_m3 = jcall(jm.m3(jm.nchunks), *args)
    assert np.array_equal(want_m1, want_m3)
    src, table, starts, lidx = (a.numpy() for a in port_inputs(w))
    for wave in (3, 5, 1056):
        assert np.array_equal(emulate_kernel(src, table, starts, lidx,
                                             ARGS[2], rows_per_step, wave),
                              want_m3)


#: (nck, cap, span, w, nd, wave): chunks no multiple of the wave, cap no
#: multiple of a pass of task rows, W = 12 (3 chunks a row), a window as
#: wide as the table, one chunk's tasks over several blocks
RAGGED = [(7, 1000, 300, 8, 700, 3), (5, 77, 10, 12, 40, 2),
          (3, 600, 1000, 128, 1500, 5), (11, 130, 512, 32, 600, 4),
          (2, 2100, 4096, 16, 5000, 3), (1, 900, 64, 128, 64, 7)]


@pytest.mark.parametrize("nck,cap,span,w,nd,wave", RAGGED)
@pytest.mark.parametrize("rows_per_step", [1, 8])
def test_emulated_kernels_ragged(nck, cap, span, w, nd, wave, rows_per_step):
    """Starts outside [0, nd - span] and local indices outside [0, span),
    against the plain version; and against JAX m1 with the indices clipped
    into the window and the starts to >= 0 (its dynamic_slice clamps a start
    past nd - span as the kernel does, but counts a negative one from the
    end, where the kernel, like the Pallas m3's DMA, starts at 0)."""
    rng = np.random.default_rng(nck * cap + w)
    table = rng.integers(0, 1 << 32, size=(nd, w), dtype=np.uint64
                         ).astype(np.uint32).view(np.int32)
    src = rng.integers(0, 1 << 32, size=(nck, cap, w), dtype=np.uint64
                       ).astype(np.uint32).view(np.int32)
    starts = rng.integers(-span, nd + span, size=nck).astype(np.int32)
    lidx = np.sort(rng.integers(-3, span + 3, size=(nck, cap)), axis=1
                   ).astype(np.int32)
    want = cuda_window.window_count_plain(
        *(torch.from_numpy(a) for a in (src, table, starts, lidx)),
        span=span).numpy()
    assert np.array_equal(emulate_kernel(src, table, starts, lidx, span,
                                         rows_per_step, wave), want)
    inside, ahead = np.clip(lidx, 0, span - 1), np.maximum(starts, 0)
    got = emulate_kernel(src, table, ahead, inside, span, rows_per_step,
                         wave)
    assert np.array_equal(got, _jax_m1(src, table, ahead, inside, span))


@pytest.mark.parametrize("n_tasks,w,wave,want", [
    (802_816, 128, 1056, 1056), (4096, 128, 1056, 512), (40, 8, 1056, 1),
    (5 * 77, 12, 2, 2), (0, 32, 1056, 1)])
def test_grid_blocks(n_tasks, w, wave, want):
    """One wave at most, and no more blocks than passes of task rows (a pass
    is BLOCK / (w / 4) tasks side by side), at least one."""
    assert cuda_window.grid_blocks(n_tasks, w, wave) == want


@pytest.mark.parametrize("nck,cap", [(0, 5), (3, 0)])
def test_window_no_tasks(nck, cap):
    """No chunks, or chunks of no tasks: zeros, one a chunk."""
    got = cuda_window.window_count(
        torch.zeros((nck, cap, 8), dtype=torch.int32),
        torch.zeros((16, 8), dtype=torch.int32),
        torch.zeros(nck, dtype=torch.int32),
        torch.zeros((nck, cap), dtype=torch.int32), span=4, rows_per_step=1)
    assert got.dtype == torch.int32 and got.tolist() == [0] * nck


def _jax_m1(src, table, starts, lidx, span):
    """The JAX script's m1 (dynamic_slice window, row take, popcount) at
    these shapes, written out with jax.numpy as the script writes it."""
    import jax.numpy as jnp

    def one(s, st, li):
        win = jax.lax.dynamic_slice(jnp.asarray(table), (st, 0),
                                    (span, table.shape[1]))
        return jnp.sum(jax.lax.population_count(s & win[li]),
                       dtype=jnp.int32)
    with jax.enable_x64(False):
        return np.asarray(jax.lax.map(lambda xs: one(*xs), (
            jnp.asarray(src), jnp.asarray(starts), jnp.asarray(lidx))))
