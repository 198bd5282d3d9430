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


@pytest.mark.parametrize("w,span,wb", [(8, 1024, 8), (128, 1024, 16),
                                       (128, 256, 64), (16, 4096, 4)])
def test_slice_width(w, span, wb):
    assert cuda_window.slice_width(w, span) == wb
    assert span * wb * 4 <= cuda_window.WINDOW_SMEM


def test_window_rejects_bad_args():
    src = torch.zeros((2, 4, 8), dtype=torch.int32)
    table = torch.zeros((16, 8), dtype=torch.int32)
    st = torch.zeros(2, dtype=torch.int32)
    li = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_per_step"):
        cuda_window.window_count(src, table, st, li, span=4, rows_per_step=2)
    with pytest.raises(ValueError, match="span"):
        cuda_window.window_count(src, table, st, li, span=17, rows_per_step=1)
