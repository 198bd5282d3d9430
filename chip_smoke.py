#!/usr/bin/env python3
"""Smoke test of graphminer_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's main path — exact triangle counting on RMAT scale 18,
edge factor 16, seed 7 (82,947,332 triangles) — and fails (non-zero exit,
no result line) when any phase fails:

  1. card and versions; exits when torch.cuda.is_available() is false;
  2. builds the CUDA kernels from graphminer_tpu_torch/csrc with nvcc;
  3. holds kernels A, B and C against their plain PyTorch versions on the
     card, exactly: random inputs over every width class, then the real
     buckets of an rmat14 build (whose counts must be 2,860,691);
  4. runs `python -m graphminer_tpu_torch tc <rmat18> --fast --json
     --profile` and checks its count and that kernel A launched;
  5. runs the ring engine on the same graph and checks its count and that
     kernels B and C launched;
  6. times both engines' device counts with CUDA events (median of 11 after
     warm-up), kernel and plain version side by side.

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}. The rmat18 graph is written under the
git-ignored graph_cache/ directory.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {14: 2_860_691, 18: 82_947_332}     # rmat(scale, 16, seed=7)
PREFIX = os.path.join(REPO, "graph_cache", "rmat18_ef16_seed7", "graph")
REPS = 11
SENTINEL = 0x7FFFFFFF
CARD = "unknown card"

KERNELS = {
    "stream_bucket_count": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/stream_count.cu",
        "replaces": "graphminer_tpu/ops/stream.py:353"},
    "ring_phase_c": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/ring_phase_c.cu",
        "replaces": "graphminer_tpu/ops/pallas_ring.py:41"},
    "ring_tail_pairs": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/ring_tail_pairs.cu",
        "replaces": "graphminer_tpu/ops/ring.py:361"},
}
MAX_ERR = {k: 0 for k in KERNELS}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(msg):
    print(msg, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return (r.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def check_environment():
    global CARD
    CARD = card_line()
    say(CARD)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")


def build_kernels():
    from graphminer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.kernels()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({_build.lib_path()})")
    if _build.BUILD_INFO:
        for line in _build.BUILD_INFO["log"].splitlines():
            if "Used" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")


def compare(name, kernel_val, plain_val, what):
    k, p = int(kernel_val), int(plain_val)
    MAX_ERR[name] = max(MAX_ERR[name], abs(k - p))
    check(k == p, f"{name} {what}: kernel {k} != plain {p}")


# --------------------------------------------------------------------------
# phase 3: kernel == plain
# --------------------------------------------------------------------------

def _tails(rng, rows, width, fill_max):
    """[rows, width] sorted unique non-negative ids, SENTINEL padded."""
    gaps = rng.integers(1, 12, size=(rows, width))
    vals = np.cumsum(gaps, axis=1).astype(np.int32)
    k = rng.integers(0, min(width, fill_max) + 1, size=rows)
    vals[np.arange(width)[None, :] >= k[:, None]] = SENTINEL
    return vals


def _words(rng, shape):
    """Random int32 words; about half have bit 31 set."""
    return rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64
                        ).astype(np.int32)


def kernel_checks_random():
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    from graphminer_tpu_torch.ops.ring import C_CLASSES, T_CLASSES
    from graphminer_tpu_torch.ops.stream import WIDTH_CLASSES
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_cases = 0
    # A: every ws x wtv (plus a wt_pad-like width), widths cycling
    for i, (ws, wtv, wta) in enumerate(
            [(ws, wtv, wta) for ws in (8, 32, 128)
             for wtv, wta in ((0, 0), (16, 8), (16, 0), (48, 32), (48, 64),
                              (200, 96))]):
        width = WIDTH_CLASSES[i % len(WIDTH_CLASSES)]
        n = max(8, min(256, (1 << 22) // (width * (ws + wta))))
        d = np.concatenate([_words(rng, (n, ws)),
                            _tails(rng, n, wtv, wtv)], axis=1)
        s = np.concatenate([_words(rng, (n * width, ws)),
                            _tails(rng, n * width, wta, wta)], axis=1)
        empty = rng.random(n * width) < 0.2          # SENTINEL src slots
        s[empty, :ws] = 0
        s[empty, ws:] = SENTINEL
        s = s.reshape(n, width, ws + wta)
        dd, sd = t(d), t(s)
        compare("stream_bucket_count",
                cuda_stream.stream_bucket_count(dd, sd, ws=ws, wtv=wtv),
                cuda_stream.stream_bucket_count_plain(dd, sd, ws=ws, wtv=wtv),
                f"random ws={ws} wtv={wtv} wta={wta} width={width}")
        n_cases += 1
    # B: every C_CLASSES width at the core table's 128 words, then other
    # word counts (small cores, and the generic path above 128 words)
    for wc, words, n_table in ([(wc, 128, 4096) for wc in C_CLASSES]
                               + [(64, 8, 200), (64, 40, 1300),
                                  (16, 264, 8448)]):
        n = max(8, min(512, (1 << 20) // wc))
        table, src = _words(rng, (n_table, words)), _words(rng, (n, words))
        dl = rng.integers(-3, n_table + 3, size=(n, wc)).astype(np.int32)
        dl[rng.random((n, wc)) < 0.1] = SENTINEL
        args = t(table), t(src), t(dl)
        compare("ring_phase_c", cuda_ring.ring_phase_c(*args),
                cuda_ring.ring_phase_c_plain(*args),
                f"random wc={wc} words={words}")
        n_cases += 1
    # C: tail tables of every T_CLASSES width against a few partners
    for wa in T_CLASSES:
        for wb in (8, 128, 2048):
            na, nb = 300, 200
            ta, tb = _tails(rng, na, wa, wa), _tails(rng, nb, wb, wb)
            n = max(8, min(4096, (1 << 22) // (wa * wb)))
            sa = rng.integers(-2, na + 2, size=n).astype(np.int32)
            sb = rng.integers(-2, nb + 2, size=n).astype(np.int32)
            sa[rng.random(n) < 0.05] = SENTINEL
            args = t(ta), t(tb), t(sa), t(sb)
            compare("ring_tail_pairs", cuda_ring.ring_tail_pairs(*args),
                    cuda_ring.ring_tail_pairs_plain(*args),
                    f"random wa={wa} wb={wb}")
            n_cases += 1
    torch.cuda.synchronize()
    say(f"kernel == plain on random inputs: {n_cases} cases exact")


def bucket_calls(stream_eng, ring_eng):
    """{kernel name: (wrapper, plain version, [(args, kwargs) per bucket])}
    over the two engines' layouts, as their counts call them."""
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    lay = ring_eng.layout
    return {
        "stream_bucket_count": (
            cuda_stream.stream_bucket_count,
            cuda_stream.stream_bucket_count_plain,
            [((b.dst_rows, b.src_rows), dict(ws=b.ws, wtv=b.wtv))
             for b in stream_eng.stream.buckets]),
        "ring_phase_c": (
            cuda_ring.ring_phase_c, cuda_ring.ring_phase_c_plain,
            [((lay.core_bm, b.src_bm, b.dst_loc), {}) for b in lay.cbuckets]
            + [((lay.bm_table, b.src_bm, b.dst_loc), {})
               for b in lay.bbuckets]),
        "ring_tail_pairs": (
            cuda_ring.ring_tail_pairs, cuda_ring.ring_tail_pairs_plain,
            [((lay.tail_tables[b.ta], lay.tail_tables[b.tv], b.src_slot,
               b.dst_slot), {}) for b in lay.tbuckets]),
    }


def kernel_checks_rmat14():
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.ring import RingEngine
    from graphminer_tpu_torch.ops.stream import StreamEngine
    g = rmat(14, 16, seed=7)
    se, re_ = StreamEngine(g, device="cuda"), RingEngine(g, device="cuda")
    sizes = {}
    for name, (kern, plain, calls) in bucket_calls(se, re_).items():
        for args, kw in calls:
            compare(name, kern(*args, **kw), plain(*args, **kw),
                    f"rmat14 bucket {[tuple(a.shape) for a in args]}")
        sizes[name] = len(calls)
    torch.cuda.synchronize()
    s, r = se.count(), re_.count()
    check(s == GOLDEN[14] and r == GOLDEN[14],
          f"rmat14 counts stream {s} ring {r} != {GOLDEN[14]}")
    say(f"rmat14: kernel == plain on every bucket {sizes}; "
        f"stream = ring = {s}")


# --------------------------------------------------------------------------
# phases 4-6: main path, ring engine, timing
# --------------------------------------------------------------------------

def write_rmat18():
    from graphminer_tpu_torch.io.loader import save_graph
    from graphminer_tpu_torch.io.synth import rmat
    t0 = time.perf_counter()
    g = rmat(18, 16, seed=7)
    save_graph(g, PREFIX)
    say(f"rmat18: V={g.n_vertices} E={g.n_edges} written to {PREFIX} "
        f"in {time.perf_counter() - t0:.1f} s")
    return g


def run_cli():
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "graphminer_tpu_torch", "tc",
                        PREFIX, "--fast", "--json", "--profile"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    sys.stderr.write(r.stderr)
    check(r.returncode == 0, f"CLI exited {r.returncode}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    launches = out["profile"]["kernel_launches"]["stream_bucket_count"]
    say(f"CLI tc --fast: total={out['total']} run_s={out['run_s']} "
        f"device_count_s={out['profile']['phases_s'].get('device_count')} "
        f"stream_bucket_count launches={launches} "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    check(out["total"] == GOLDEN[18],
          f"CLI total {out['total']} != {GOLDEN[18]}")
    check(launches > 0, "kernel A was not launched by the CLI's main path")
    return launches


def run_ring(g):
    from graphminer_tpu_torch.ops import cuda_ring
    from graphminer_tpu_torch.ops.ring import RingEngine
    t0 = time.perf_counter()
    eng = RingEngine(g, device="cuda")
    t_build = time.perf_counter() - t0
    cuda_ring.ring_phase_c.launches = 0
    cuda_ring.ring_tail_pairs.launches = 0
    total = eng.count()
    launches = {"ring_phase_c": cuda_ring.ring_phase_c.launches,
                "ring_tail_pairs": cuda_ring.ring_tail_pairs.launches}
    say(f"RingEngine rmat18: count={total} build_s={t_build:.1f} "
        f"launches={launches}")
    check(total == GOLDEN[18], f"ring count {total} != {GOLDEN[18]}")
    check(all(v > 0 for v in launches.values()),
          f"a ring kernel was not launched: {launches}")
    return eng, launches


def time_ms(fn):
    """Median device time of fn() in ms over REPS runs after warm-up, and
    the value it returned."""
    val = fn()
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), val


def timing(stream_eng, ring_eng):
    """Per-kernel and per-engine device time, kernel vs plain, in turns."""
    res = {}
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    for name, (kern, plain, calls) in bucket_calls(stream_eng,
                                                   ring_eng).items():
        run_k = lambda: sum((kern(*a, **kw) for a, kw in calls), zero)
        run_p = lambda: sum((plain(*a, **kw) for a, kw in calls), zero)
        p1, pv = time_ms(run_p)
        k1, kv = time_ms(run_k)
        k2, _ = time_ms(run_k)
        p2, _ = time_ms(run_p)
        compare(name, kv, pv, "rmat18 engine share")
        res[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
        say(f"[{CARD}] {name} at rmat18 ({len(calls)} buckets): kernel "
            f"{res[name][0]:.3f} ms, plain {res[name][1]:.3f} ms")
    engines = (
        ("stream", stream_eng, stream_eng.stream.nbytes(),
         res["stream_bucket_count"]),
        ("ring", ring_eng, ring_eng.layout.nbytes(),
         tuple(a + b for a, b in zip(res["ring_phase_c"],
                                     res["ring_tail_pairs"]))))
    for label, eng, nbytes, (k_ms, p_ms) in engines:
        e_ms, total = time_ms(lambda: eng.partials().sum())
        check(int(total) == GOLDEN[18], f"{label} total {int(total)}")
        say(f"[{CARD}] {label} engine rmat18 device count: {e_ms:.3f} ms "
            f"(kernel parts {k_ms:.3f} ms, plain {p_ms:.3f} ms); "
            f"edge tasks/s {eng.n_edges / (e_ms / 1e3):.4e} kernel, "
            f"{eng.n_edges / (p_ms / 1e3):.4e} plain; "
            f"{eng.n_edges} edge tasks; layout {nbytes} bytes")
    return res


def main():
    check_environment()
    build_kernels()
    kernel_checks_random()
    kernel_checks_rmat14()

    g = write_rmat18()
    launches = {"stream_bucket_count": run_cli()}
    ring_eng, ring_launches = run_ring(g)
    launches.update(ring_launches)

    from graphminer_tpu_torch.ops.stream import StreamEngine
    t0 = time.perf_counter()
    stream_eng = StreamEngine(g, device="cuda")
    say(f"StreamEngine rmat18 build: {time.perf_counter() - t0:.1f} s, "
        f"{len(stream_eng.stream.buckets)} buckets")
    res = timing(stream_eng, ring_eng)
    torch.cuda.synchronize()

    say(json.dumps({"kernels": [
        dict(name=k, **KERNELS[k], launches=launches[k],
             max_abs_err=MAX_ERR[k], ms=res[k][0], plain_ms=res[k][1])
        for k in KERNELS]}))
    say(CARD)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
