"""Host-clock spans at the port's layer boundaries: an opt-in recorder.

The serving step and the train step open a span at each layer boundary
(`vap.tick`, `vap.upload`, `vap.encode`, `vap.trunk`, `vap.attend`,
`vap.merge`, `vap.heads`, `vap.probs`, `vap.resync`, `vap.reset`;
`vap.train.step`, `vap.forward`, `vap.loss`, `vap.backward`,
`vap.optimizer`; `vap.serve.*` in the native server).  The recorder is
off unless a caller turns it on:

    from vap_realtime_tpu_torch.utils import spans
    spans.enable(True)
    ...                                  # ticks or train steps
    records = spans.take()               # and clear
    spans.enable(False)

Each record is a `Span`: name, start and end on `time.perf_counter_ns()`,
the index of its parent in the list `take()` returns (the innermost span
open on the same thread when it started; -1 for none), an identifier
shared by every span of one tick or train step (the state's tick counter,
the step's index; children inherit it), and an optional count measured
where the work happens (bytes uploaded, slots reset, streams served).
The times are host times: a span ends when the host returns, not when
the device finishes, and the recorder never waits for the device.
`self_times` sums each name's host time less its children's.

Off, `span()` returns one shared do-nothing context (one flag test, no
allocation, no clock read) and `traced` calls straight through.  On, the
store keeps the newest `MAX_RECORDS` records and counts what it drops,
so a server left recording cannot grow without limit.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

MAX_RECORDS = 1 << 17


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    id: Optional[int]
    n: Optional[int]


class _Recorder:
    """The process's store: closed spans in a bounded deque (each with
    the sequence number it opened with and its parent's), the open spans
    of each thread on a thread-local stack."""

    def __init__(self, capacity: int = MAX_RECORDS):
        self.on = False
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.seq = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: tuple) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)


_rec = _Recorder()


class _Open:
    """One span while it is open (only built with the recorder on)."""

    __slots__ = ("name", "n", "id", "seq", "parent", "t0")

    def __init__(self, name: str, n: Optional[int], id: Optional[int]):
        self.name, self.n, self.id = name, n, id

    def __enter__(self):
        st = _rec.stack()
        top = st[-1] if st else None
        self.parent = top.seq if top is not None else -1
        if self.id is None and top is not None:
            self.id = top.id
        self.seq = next(_rec.seq)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = _rec.stack()
        if st and st[-1] is self:
            st.pop()
        _rec.add((self.seq, self.name, self.t0, t1, self.parent, self.id,
                  self.n))
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, n: Optional[int] = None, id: Optional[int] = None):
    """A context that records `name` around its block when the recorder
    is on.  n: a count of the work inside; id: the tick or step
    identifier (default: the enclosing span's)."""
    if not _rec.on:
        return _NULL
    return _Open(name, n, id)


def traced(name: str):
    """Decorator: the function's calls as spans named `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _rec.on:
                return fn(*args, **kwargs)
            with _Open(name, None, None):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def enable(on: bool = True) -> None:
    """Turn the recorder on or off.  Spans open at the switch still
    record when they close."""
    _rec.on = bool(on)


def enabled() -> bool:
    return _rec.on


def dropped() -> int:
    """Records dropped as the oldest of a full store, since the last
    `take()`."""
    return _rec.dropped


def take() -> List[Span]:
    """The recorded spans, ordered by start, and clear the store (and
    the drop count).  A parent index of -1: no parent, or the parent was
    dropped."""
    with _rec.lock:
        raw = list(_rec.records)
        _rec.records.clear()
        _rec.dropped = 0
    raw.sort(key=lambda r: (r[2], r[0]))
    at = {r[0]: i for i, r in enumerate(raw)}
    return [Span(name, s, e, at.get(parent, -1), id, n)
            for _, name, s, e, parent, id, n in raw]


def self_times(records: List[Span]) -> Dict[str, Dict[str, float]]:
    """Per span name: its count, its host time in ms and its self time
    in ms (each span's duration less its children's), and its summed n."""
    child_ns = [0] * len(records)
    for r in records:
        if r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for r, c in zip(records, child_ns):
        d = out.setdefault(r.name, {"count": 0, "ms": 0.0, "self_ms": 0.0,
                                    "n": 0})
        d["count"] += 1
        d["ms"] += (r.end_ns - r.start_ns) * 1e-6
        d["self_ms"] += (r.end_ns - r.start_ns - c) * 1e-6
        d["n"] += r.n or 0
    return out
