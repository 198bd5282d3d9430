"""Port set-operation vocabulary (graphminer_tpu_torch/ops/setops.py)
against the JAX package's graphminer_tpu.ops.setops on the same numpy
inputs: every op, both backends, several widths, with empty rows,
all-SENTINEL rows and bounded rows. Results must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.ops import setops as jsetops
from graphminer_tpu_torch.ops import setops
from graphminer_tpu_torch.types import SENTINEL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these tests issue many small torch ops, and under
    xdist the workers' intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTHS = [8, 16, 100, 128]
BACKENDS = ["bc", "bs"]


def random_rows(rng, b, w, hi=1000, frac=0.7):
    """Sorted SENTINEL-padded rows with random lengths; row 0 is empty and
    row 1 full (when w <= hi)."""
    out = np.full((b, w), SENTINEL, dtype=np.int32)
    lens = rng.integers(0, int(w * frac) + 1, b)
    lens[0], lens[1] = 0, min(w, hi)
    for i, n in enumerate(lens):
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


def query_rows(rng, b, w, hi=1000):
    """a-side rows: any order, SENTINEL holes, one all-SENTINEL row."""
    a = rng.integers(0, hi, (b, w)).astype(np.int32)
    a[rng.random((b, w)) < 0.3] = SENTINEL
    a[2] = SENTINEL
    return a


def inputs(w, seed=0, b=32):
    rng = np.random.default_rng(seed + w)
    a = query_rows(rng, b, w)
    bb = random_rows(rng, b, w)
    upper = rng.integers(0, 1000, b).astype(np.int32)
    return a, bb, upper


def both(op, *args, **kw):
    """(port result, JAX result) of one op on the same numpy inputs."""
    ours = getattr(setops, op)(*(torch.from_numpy(x) for x in args), **kw)
    ref = getattr(jsetops, op)(*(jnp.asarray(x) for x in args), **kw)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("op", ["intersect_count", "intersect",
                                "difference_count", "difference"])
@pytest.mark.parametrize("bounded", [False, True])
def test_set_ops_equal_jax(op, w, backend, bounded):
    a, b, upper = inputs(w)
    args = (a, b, upper) if bounded else (a, b)
    ours, ref = both(op, *args, backend=backend)
    assert ours.dtype == ref.dtype
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_member_and_connected_equal_jax(w, backend):
    a, b, _ = inputs(w, seed=1)
    ours, ref = both("member", a, b, backend=backend)
    assert np.array_equal(ours, ref)
    x = np.concatenate([b[:16, 0], a[16:, 3]])   # members, SENTINELs, misses
    ours, ref = both("connected", x, b, backend=backend)
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("w", WIDTHS)
def test_bounded_exclude_count_valid_equal_jax(w):
    a, _, upper = inputs(w, seed=2)
    rng = np.random.default_rng(w)
    anc = rng.integers(0, 1000, (a.shape[0], 3)).astype(np.int32)
    anc[:, 0] = a[:, 0]
    anc[5] = SENTINEL
    for op, args in (("bounded", (a, upper)), ("exclude", (a, anc)),
                     ("count_valid", (a,)), ("count_valid", (a, upper))):
        ours, ref = both(op, *args)
        assert np.array_equal(ours, ref), op


@pytest.mark.parametrize("w", WIDTHS)
def test_backends_equal_on_wide_and_mixed_widths(w):
    rng = np.random.default_rng(w + 9)
    a = query_rows(rng, 16, w, hi=5000)
    b = random_rows(rng, 16, 3 * w + 5, hi=5000)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for op in ("intersect", "difference_count"):
        want = np.asarray(getattr(jsetops, op)(jnp.asarray(a),
                                               jnp.asarray(b), backend="bc"))
        for backend in ("bc", "bs", "auto"):
            got = getattr(setops, op)(ta, tb, backend=backend).numpy()
            assert np.array_equal(got, want), (op, backend)


def test_bc_row_blocks(monkeypatch):
    """A block budget of 3 rows' compares: several row blocks, same
    result as one block and as JAX."""
    a, b, upper = inputs(100, seed=3)
    want = np.asarray(jsetops.intersect_count(
        jnp.asarray(a), jnp.asarray(b), upper=jnp.asarray(upper),
        backend="bc"))
    one = setops.intersect_count(torch.from_numpy(a), torch.from_numpy(b),
                                 upper=torch.from_numpy(upper), backend="bc")
    monkeypatch.setattr(setops, "BC_BUDGET", 3 * 100 * 100)
    blocks = setops.intersect_count(torch.from_numpy(a), torch.from_numpy(b),
                                    upper=torch.from_numpy(upper),
                                    backend="bc")
    assert np.array_equal(one.numpy(), want)
    assert np.array_equal(blocks.numpy(), want)


def test_empty_widths_and_unknown_backend():
    a = torch.full((4, 0), SENTINEL, dtype=torch.int32)
    b = torch.full((4, 8), SENTINEL, dtype=torch.int32)
    for backend in BACKENDS:
        got = setops.intersect_count(a, b, backend=backend)
        assert got.tolist() == [0] * 4
        assert setops.member(b, a[:, :0], backend=backend).sum() == 0
    with pytest.raises(ValueError):
        setops.intersect_count(b, b, backend="nope")


def test_auto_picks_by_device():
    a = torch.zeros((2, 8), dtype=torch.int32)
    assert setops._default_backend(a) == "auto_cpu"
