"""Kernel R's plain version and the port's probe scripts
(graphminer_tpu_torch/scripts/{launch_check,prof_breakdown}.py) on the CPU
at small sizes; the card runs them at full size in chip_smoke.py."""
import numpy as np
import pytest
import torch

from graphminer_tpu_torch.ops import cuda_check
from graphminer_tpu_torch.scripts import (launch_check, prof_breakdown,
                                          prof_window)


def test_times_two_plain_wraps_like_int32():
    rng = np.random.default_rng(0)
    x = rng.integers(-(1 << 31), 1 << 31, size=(8, 128), dtype=np.int64
                     ).astype(np.int32)
    x[0, :3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, -1]
    got = cuda_check.times_two(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (8, 128)
    assert np.array_equal(got.numpy(), x * np.int32(2))


def test_launch_check_on_cpu(capsys):
    launch_check.main(["--device", "cpu"])
    assert capsys.readouterr().out.startswith("OK: 2 in")


def test_prof_breakdown_on_cpu(monkeypatch, capsys):
    """The script's whole flow at scale 12 with a small fetch table: the
    tail and spoke counts add up to the graph's triangle count (the same
    as the stream engine's), and every fetch shape ran and agreed."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.stream import triangle_count_stream
    monkeypatch.setattr(prof_breakdown, "SCALE", 12)
    monkeypatch.setattr(prof_breakdown, "FETCH_ROWS", 1 << 10)
    monkeypatch.setattr(prof_breakdown, "FETCH_COUNTS", (64, 512))
    monkeypatch.setattr(prof_breakdown, "REPS", 1)
    res = prof_breakdown.main(["--device", "cpu"])
    want = triangle_count_stream(rmat(12, 16, seed=7), device="cpu")
    assert res["tail"]["count"] + res["spoke"]["count"] == want
    assert len(res["fetch"]) == 8
    out = capsys.readouterr().out
    assert "tail:" in out and "spoke:" in out and "fetch w= 256" in out


def test_prof_breakdown_clique_on_cpu(monkeypatch, capsys):
    """--clique at scale 10: every form of the hi part (the flat list on 1,
    2 and 4 streams, the bucket form at k = 5) reaches the engine's hi
    total (the script raises otherwise), and the buckets expand more rows
    than the flat list, which expands each triangle task once."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    monkeypatch.setattr(prof_breakdown, "SCALE", 10)
    monkeypatch.setattr(prof_breakdown, "REPS", 1)
    res = prof_breakdown.main(["--device", "cpu", "--clique"])["clique"]
    eng = CliqueKEngine(rmat(10, 16, seed=7), 5, device="cpu")
    rows = res[5]["expanded_rows"]
    assert rows["flat"] == -(-eng.n_tri // 32) * 32 < rows["buckets"]
    assert res[5]["hi"] == int(eng.hi_partials().sum()) > 0
    assert sorted(res[4]["ms"]) == [f"flat, {n} streams" for n in (1, 2, 4)]
    assert all(len(v) == 2 for k in (4, 5) for v in res[k]["ms"].values())
    assert "clique k=5 hi part" in capsys.readouterr().out


@pytest.mark.parametrize("scale,core", [(10, 64), (10, 32), (12, 64)])
def test_tail_bytes_counts_each_named_row_prefix_once(scale, core):
    """E's bound bytes against a per-task walk: each row a real task names,
    as wide as the widest clamped prefix its groups read, the real task ids
    and one int64 per group; never more than the whole tables. (10, 32) and
    (12, 64) have class-64 groups wider than the stored tail (wt_pad 32 and
    48), so the clamp is exercised."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.hubcore import TriangleEngine
    from graphminer_tpu_torch.types import SENTINEL
    eng = TriangleEngine(rmat(scale, 16, seed=7), core=core, chunk=128,
                         device="cpu")
    words = eng.layout.words
    wt = eng.tables.src_rows.shape[1] - words
    src_w, dst_w, n_tasks = {}, {}, 0
    for (s, d), (wa, wb, _ck) in zip(eng.group_arrays, eng.spec):
        wa_, wb_ = min(wa, wt), min(wb, wt)
        if not (wa_ and wb_):
            wa_ = wb_ = 0
        for u, v in zip(s.reshape(-1).tolist(), d.reshape(-1).tolist()):
            if u == SENTINEL:
                continue
            n_tasks += 1
            src_w[u] = max(src_w.get(u, 0), words + wa_)
            dst_w[v] = max(dst_w.get(v, 0), words + wb_)
    want = 4 * (sum(src_w.values()) + sum(dst_w.values()) + 2 * n_tasks) \
        + 8 * len(eng.spec)
    assert n_tasks == eng.n_tail_tasks > 0
    got = prof_breakdown.tail_bytes(eng)
    assert got == want
    tab = eng.tables
    assert got <= 4 * (tab.src_rows.numel() + tab.dst_rows.numel()
                       + sum(s.numel() + d.numel()
                             for s, d in eng.group_arrays)) + 8 * len(eng.spec)


@pytest.mark.parametrize("script,argv", [
    (launch_check, []), (prof_breakdown, []),
    (prof_window, ["1024", "256", "128", "8"])])
def test_scripts_need_a_card_by_default(monkeypatch, script, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)
