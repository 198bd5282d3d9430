"""Where do the hub-core engine's rmat18 milliseconds go?

The port of scripts/prof_breakdown.py. Builds TriangleEngine
(ops/hubcore.py) on RMAT scale 18, edge factor 16, seed 7, times its two
halves apart — the tail groups (kernel E, ops/cuda_hubcore.py) and the spoke
product (torch._int_mm; on its first slab, also the bit expansion by kernel
X in both output layouts and by its plain version, and the product in both
operand layouts) — and then calibrates the random-row fetch rate of
kernel D (ops/fetch.py) at the row widths the tail count reads: a 2^18-row
int32 table of width W ∈ {8, 32, 128, 256}, T ∈ {2^16, 2^19} random indices,
n_buf = 16. Each D result is held against the plain version, exactly.

With --clique it times the hi part of CliqueKEngine (ops/cliquek.py) on
the same graph instead: the Gram (X + torch._int_mm) on 1, 2 and 4 CUDA
streams at k = 4 and 5, and at k = 5 the engine's flat triangle-task list
against the JAX package's _bucket_tris form of the same tasks (per-edge
rows of SENTINEL-padded c slots), each held to one hi total.

    python -m graphminer_tpu_torch.scripts.prof_breakdown [--device cuda|cpu]
        [--clique]

Times are medians of CUDA-event timings after warm-up (the host's dispatch
of a call included), each printed with the least time an H100 could take
for the same work; each D shape also with its device time alone
(torch.profiler) and the rate on the n·4W gathered bytes. The table values
(0..99) and indices come from torch generators seeded 0 and 1, 2, ...
Left out: the jnp.roll variants (they defeated a TPU runtime's
memoization) and the try/except around the Pallas fetch: a failing kernel
raises here and the process exits non-zero.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..types import SENTINEL, round_up
from ..io.synth import rmat
from ..ops import hubcore
from ..ops.cliquek import HI_STREAMS, CliqueKEngine, _bucket_tris, slab_gram
from ..ops.cuda_expand import expand_bits, expand_bits_plain
from ..ops.fetch import fetch_rows_sum, fetch_rows_sum_plain
from ..utils.profiling import bound_ms, device_ms, time_ms

SCALE = 18
FETCH_ROWS = 1 << 18
FETCH_WIDTHS = (8, 32, 128, 256)
FETCH_COUNTS = (1 << 16, 1 << 19)
N_BUF = 16
REPS = 5


def fetch_inputs(w: int, n: int, i: int, dev: torch.device):
    """(idx int32 [n], table int32 [FETCH_ROWS, w]) for the i-th index set."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    tbl = torch.randint(0, 100, (FETCH_ROWS, w), generator=g, device=dev,
                        dtype=torch.int32)
    g.manual_seed(i + 1)
    idx = torch.randint(0, FETCH_ROWS, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    return idx, tbl


def fetch_bound(idx: torch.Tensor, w: int):
    """bound_ms of D: idx, the distinct rows it names and the output."""
    rows = int(torch.unique(idx).numel())
    return bound_ms(4 * (idx.numel() + rows * w + w))


def tail_bytes(eng) -> int:
    """The bytes kernel E must move for eng's tail groups: each row that a
    real task names (SENTINEL padding names none), read once as far as the
    widest prefix any of its groups reads (words + the clamped class width,
    words alone in a popcount-only group, as hub_tail_count clamps them),
    the real task ids, and one int64 count per group."""
    tab, words = eng.tables, eng.layout.words
    wt = tab.src_rows.shape[1] - words
    need = [torch.zeros(t.shape[0], dtype=torch.int64, device=t.device)
            for t in (tab.src_rows, tab.dst_rows)]
    n_tasks = 0
    for (s, d), (wa, wb, _ck) in zip(eng.group_arrays, eng.spec):
        s, d = s.reshape(-1), d.reshape(-1)
        ok = ((s >= 0) & (s < need[0].numel())
              & (d >= 0) & (d < need[1].numel()))
        wa_, wb_ = min(wa, wt), min(wb, wt)
        if wa_ == 0 or wb_ == 0:
            wa_ = wb_ = 0
        for n, ids, w in ((need[0], s[ok].long(), words + wa_),
                          (need[1], d[ok].long(), words + wb_)):
            n[ids] = torch.clamp(n[ids], min=w)
        n_tasks += int(ok.sum())
    return 4 * (int(need[0].sum()) + int(need[1].sum()) + 2 * n_tasks) \
        + 8 * len(eng.spec)


def spoke_slab(eng, dev) -> dict:
    """The spoke's parts on its first slab: the bit expansion by kernel X
    transposed (the engine's form) and row-major, and by X's plain version
    (the torch ops the spoke ran before X, transposed), each beside its
    bytes bound; then torch._int_mm on X's transposed output (xt, xt.t())
    and on its row-major output (x.t(), x), both held to one product."""
    lay = eng.layout
    cpad = lay.words * 32
    slab = eng.spoke[:hubcore.MAX_SLAB]
    rows = slab.shape[0]
    out = {"rows": rows}
    for key, fn in (
            ("expand_ms", lambda: expand_bits(slab, transpose=True)),
            ("expand_rows_ms", lambda: expand_bits(slab)),
            ("expand_plain_ms",
             lambda: expand_bits_plain(slab, transpose=True))):
        out[key], _ = time_ms(fn, dev, REPS)
    xt = expand_bits(slab, transpose=True)
    x = expand_bits(slab)
    out["int_mm_ms"], g_t = time_ms(lambda: torch._int_mm(xt, xt.t()), dev,
                                    REPS)
    out["int_mm_rows_ms"], g_r = time_ms(lambda: torch._int_mm(x.t(), x),
                                         dev, REPS)
    if not torch.equal(g_t, g_r):
        raise RuntimeError("spoke slab: the two _int_mm layouts disagree")
    out["expand_bound"] = bound_ms(rows * cpad + slab.numel() * 4)
    out["int_mm_bound"] = bound_ms(0, 2 * cpad * cpad * rows)
    print(f"spoke slab of {rows} rows: expand by X transposed "
          f"{out['expand_ms']:.4f} ms, row-major {out['expand_rows_ms']:.4f}"
          f" ms, plain (torch ops) {out['expand_plain_ms']:.3f} ms (H100 "
          f"bound {out['expand_bound'][0]:.4f} ms); _int_mm (xt, xt.t()) "
          f"{out['int_mm_ms']:.3f} ms, (x.t(), x) {out['int_mm_rows_ms']:.3f}"
          f" ms (H100 bound {out['int_mm_bound'][0]:.4f} ms)", flush=True)
    return out


def bucket_calls(eng) -> list:
    """X's calls for the JAX package's form of a k = 5 engine's hi tasks:
    _bucket_tris groups the flat list into rows of 2-2048 c slots a bucket
    (an edge's y₂ hi slice and its c ids, SENTINEL padded), and each slot is
    one expanded row. Slabs of at most eng.slab rows, whole bucket rows, as
    the JAX package steps them; the row of slot i is i // slots, passed to X
    as explicit rows."""
    dev = eng.device
    tri = torch.stack([eng.tri_rows, eng.tri_cols[:, 0]], 1).cpu().numpy()
    tab = eng.core[:, eng.words - eng.hi_words:]
    calls = []
    for rows, cm, _step, _rt in _bucket_tris(eng.y2hi.cpu().numpy(), tri):
        tcl = cm.shape[1]
        rows = torch.from_numpy(rows).to(dev)
        cols = torch.from_numpy(cm).to(dev).reshape(-1, 1)
        r = torch.arange(cols.shape[0], dtype=torch.int32, device=dev) // tcl
        step = max(1, eng.slab // tcl) * tcl
        for s in range(0, cols.shape[0], step):
            n = min(step, cols.shape[0] - s)
            calls.append((rows, dict(r=r[s:s + n], tab=tab,
                                     cols=cols[s:s + n],
                                     n_out=round_up(n, 32), transpose=True)))
    return calls


def clique_hi(dev) -> dict:
    """CliqueKEngine's hi part at k = 4 and 5, in turns: the Gram on 1, 2
    and 4 streams, and at k = 5 the flat list against the bucket form (both
    on HI_STREAMS streams); every reading held to the engine's hi total."""
    g = rmat(SCALE, 16, seed=7)
    cuda = dev.type == "cuda"
    res = {}
    for k in (4, 5):
        eng = CliqueKEngine(g, k, device=dev)
        want = int(eng.hi_partials().sum())
        streams = {n: ([torch.cuda.Stream(dev) for _ in range(n)]
                       if cuda and n > 1 else []) for n in (1, 2, 4)}

        def hi_of(slabs, st):
            gram = slab_gram(slabs, eng.hi_dim, dev, st)
            total = int((gram.to(torch.int64) * eng.bhh).sum())
            if total != want:
                raise RuntimeError(f"clique k={k}: hi {total} != {want}")

        def xs(calls):
            return (expand_bits(b, **kw) for b, kw in calls)

        forms = {f"flat, {n} streams": (
            lambda n=n: hi_of(eng._slabs(), streams[n])) for n in (1, 2, 4)}
        rows = {"flat": sum(eng.slab_tasks)}
        if k == 5:
            calls = bucket_calls(eng)
            rows["buckets"] = sum(kw["n_out"] for _, kw in calls)
            forms[f"buckets, {HI_STREAMS} streams"] = (
                lambda: hi_of(xs(calls), streams[HI_STREAMS]))
        got = {key: [] for key in forms}
        for key in list(forms) + list(forms)[::-1]:         # in turns
            got[key].append(time_ms(forms[key], dev, REPS)[0])
        res[k] = {"hi": want, "n_slabs": eng.n_slabs, "expanded_rows": rows,
                  "ms": got}
        print(f"clique k={k} hi part {want} ({eng.n_slabs} slabs, expanded "
              f"rows {rows}), ms in turns: " + "; ".join(
                  f"{key} {v[0]:.3f} / {v[1]:.3f}" for key, v in got.items()),
              flush=True)
        del eng
        if cuda:
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clique", action="store_true",
                    help="time CliqueKEngine's hi part instead")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {kind}", flush=True)
    if a.clique:
        return {"device": kind, "clique": clique_hi(dev)}
    t0 = time.perf_counter()
    g = rmat(SCALE, 16, seed=7)
    eng = hubcore.TriangleEngine(g, device=dev)
    lay = eng.layout
    prep = time.perf_counter() - t0
    print(f"prep={prep:.1f}s V={eng.g.n_vertices} E={eng.g.n_edges} "
          f"tail_tasks={eng.n_tail_tasks} words={lay.words} "
          f"wt_pad={lay.wt_pad} core={lay.core_size} "
          f"spoke_rows={eng.spoke.shape[0]}", flush=True)
    # (wa, wb, chunk, padded tasks, tasks) per tail group
    groups = [(wa, wb, ck, int(s.numel()), int((s != SENTINEL).sum()))
              for (s, _), (wa, wb, ck) in zip(eng.group_arrays, eng.spec)]
    print("groups (wa, wb, chunk, padded, tasks):", groups, flush=True)
    res = {"device": kind, "prep_s": prep, "groups": groups}

    # --- tail only (kernel E) ---
    tail_ms, tail = time_ms(lambda: eng.tail_partials().sum(), dev, REPS)
    t_bytes = tail_bytes(eng)
    res["tail"] = {"ms": tail_ms, "count": int(tail), "bytes": t_bytes,
                   "bound": bound_ms(t_bytes)}
    print(f"tail: {tail_ms:.3f} ms count={int(tail)} (H100 bound "
          f"{res['tail']['bound'][0]:.4f} ms, {t_bytes} bytes)",
          flush=True)

    # --- spoke only (torch._int_mm) ---
    spoke_ms, spoke = time_ms(lambda: eng.core_partials().sum(), dev, REPS)
    cpad = lay.words * 32
    ops = 2 * cpad * cpad * (eng.spoke.shape[0] if lay.core_size else 0)
    res["spoke"] = {"ms": spoke_ms, "count": int(spoke), "ops": ops,
                    "bound": bound_ms(eng.spoke.numel() * 4, ops)}
    print(f"spoke: {spoke_ms:.3f} ms count={int(spoke)} (H100 bound "
          f"{res['spoke']['bound'][0]:.4f} ms, {ops:.3e} int8 ops)",
          flush=True)
    if lay.core_size:
        res["spoke"]["slab"] = spoke_slab(eng, dev)

    # --- kernel D row-fetch calibration ---
    res["fetch"] = []
    for w in FETCH_WIDTHS:
        for n in FETCH_COUNTS:
            idx, tbl = fetch_inputs(w, n, 0, dev)
            got = fetch_rows_sum(idx, tbl, n_buf=N_BUF)
            want = fetch_rows_sum_plain(idx, tbl)
            if not torch.equal(got, want):
                raise RuntimeError(f"fetch w={w} n={n}: kernel != plain")
            call = lambda: fetch_rows_sum(idx, tbl, n_buf=N_BUF)
            ms, _ = time_ms(call, dev, REPS)
            b_ms, _ = fetch_bound(idx, w)
            gathered = n * w * 4                    # bytes of the n rows
            row = {"w": w, "n": n, "ms": ms, "bound_ms": b_ms,
                   "bytes": gathered, "device_ms": None, "ops": None}
            alone = "device alone not measured"
            if dev.type == "cuda":
                row["device_ms"], row["ops"] = device_ms(call)
                alone = (f"device alone {row['device_ms']:.4f} ms "
                         f"{gathered / row['device_ms'] / 1e6:8.2f} GB/s")
            res["fetch"].append(row)
            print(f"fetch w={w:4d} n={n:7d}: {ms:8.3f} ms "
                  f"{ms / n * 1e6:7.2f} ns/row {gathered / ms / 1e6:8.2f} "
                  f"GB/s; {alone} (H100 bound {b_ms:.4f} ms)", flush=True)
    tot = {k: sum(r[k] for r in res["fetch"]) for k in ("ms", "bound_ms")}
    if dev.type == "cuda":
        tot["device_ms"] = sum(r["device_ms"] for r in res["fetch"])
    print(f"fetch, {len(res['fetch'])} shapes: " + ", ".join(
        f"{k} {v:.4f}" for k, v in tot.items()), flush=True)
    return res


if __name__ == "__main__":
    main()
