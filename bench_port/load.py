"""The one traffic generator: it reads a mix file (bench_port/mixes/) and
drives an entry's count() with it.

A mix is a JSON object:
  "kind": "closed"   the client sends its next call when its last one has
                     returned (the only kind so far);
  "clients": 1       one client, the calling thread (the only number so
                     far: a mix with more clients needs a thread-safe
                     entry, proved on the card, first);
  "warmup_calls": W  calls the client makes before the window, part of
                     set-up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class Call:
    """One call: host-clock start and end (perf_counter s), and the value
    it returned or the error it raised."""
    start: float
    end: float
    value: Optional[int] = None
    error: Optional[str] = None


KINDS = ("closed",)


def check_mix(mix: dict) -> None:
    if mix.get("kind") not in KINDS:
        raise ValueError(f"mix kind {mix.get('kind')!r} is not one of {KINDS}")
    if int(mix.get("clients", 1)) != 1:
        raise ValueError("a mix has one client")


def _client(count: Callable[[], int], n_calls: Optional[int],
            until: Optional[float], wrap) -> List[Call]:
    """Calls count() back to back: n_calls times, or until the host clock
    passes `until` (the call in flight then runs to its end). A call that
    raises ends the client."""
    out: List[Call] = []
    while True:
        if n_calls is not None and len(out) >= n_calls:
            return out
        if until is not None and time.perf_counter() >= until:
            return out
        t0 = time.perf_counter()
        try:
            with wrap():
                v = int(count())
        except Exception as exc:  # recorded as a failed call
            out.append(Call(t0, time.perf_counter(), error=repr(exc)))
            return out
        out.append(Call(t0, time.perf_counter(), value=v))


def warmup(mix: dict, count, wrap) -> List[Call]:
    """The mix's warm-up calls."""
    return _client(count, int(mix.get("warmup_calls", 1)), None, wrap)


def window(mix: dict, count, seconds: float, wrap) -> List[Call]:
    """The measured window: calls started until `seconds` have passed,
    each waited for."""
    return _client(count, None, time.perf_counter() + seconds, wrap)
