"""The port's spans and counters, and one record per public call.

Each public entry point (zstrm.compress, compress_with_index, decompress,
RawDeflater.compress, RawInflater.decompress, RawInflater.build_index,
ShardedDeflater.compress) runs inside request(op). The
outermost request of a thread gives the call a fresh integer id; an entry
called inside an open request joins it (a crc32 inside zstrm.decompress is
part of the decode). When the outermost request closes it leaves this
thread's record, last_request():

    {"id": n, "op": "zstrm.decompress", "seconds": s,
     "spans": {name: seconds}, "counters": {name: n}}

span(name), a context manager or a decorator, adds its seconds to the open
request, and appends (name, request id or None, start_ns, end_ns) to a ring
of the RING newest spans, recent(). count(name, n) adds to a counter of the
open request (a counter a call never touched is absent from its record). A
closed request's spans and counters join the process totals in batches of
FOLD requests, or when totals() is read (a span or count outside any
request joins them at once); totals() is what an operator scrapes.

Always on, with no switch. Inside a request no lock is taken and nothing
is folded or copied: the record is built when last_request() reads it.
Stamps are Unix-epoch nanoseconds, the clock torch.profiler (Kineto)
stamps its host events in (time.time_ns() anchored once against
perf_counter_ns), so an idle gap of a device profile can be put down to
the span running at the time. No span emits
torch.profiler.record_function: the profiler would mirror it onto the
device's timeline, where it would read as busy time.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

RING = 8192                 # spans recent() keeps, newest last

_perf = time.perf_counter_ns
# perf_counter_ns() + _EPOCH is Unix-epoch ns
_EPOCH = time.time_ns() - time.perf_counter_ns()

FOLD = 256                  # closed requests that wait to join the totals


class _Local(threading.local):
    req = None              # the open request of this thread
    last = None             # its newest closed one


_local = _Local()
_ids = itertools.count(1)
_lock = threading.Lock()
# closed requests not yet in the totals: a request's close only appends to
# it, so the folding runs in batches and not among the request's own work
_closed: collections.deque = collections.deque()
_span_s: dict = collections.defaultdict(float)
_counts: dict = collections.defaultdict(int)
_requests: dict = collections.defaultdict(int)
# (name, request id or None, start, end) on the perf_counter_ns clock
_ring: collections.deque = collections.deque(maxlen=RING)


class _Open:
    """A request: open on a thread, then closed (t1 set)."""
    __slots__ = ("id", "op", "t0", "t1", "spans", "counters")

    def __init__(self, op: str):
        self.id = next(_ids)
        self.op = op
        self.spans: dict = {}
        self.counters: dict = {}
        self.t0 = _perf()

    def record(self) -> dict:
        return {"id": self.id, "op": self.op,
                "seconds": (self.t1 - self.t0) / 1e9,
                "spans": dict(self.spans), "counters": dict(self.counters)}


def _open(op: str):
    """The new request, or None where one is open on this thread."""
    if _local.req is not None:
        return None
    req = _local.req = _Open(op)
    return req


def _done(req: _Open) -> None:
    """Close the outermost request: it becomes this thread's last, and
    waits in _closed to join the totals."""
    req.t1 = _perf()
    _local.req = None
    _local.last = req
    _closed.append(req)
    if len(_closed) >= FOLD:
        _fold()


def _fold() -> None:
    """The closed requests' spans and counters into the totals."""
    with _lock:
        while _closed:
            req = _closed.popleft()
            _requests[req.op] += 1
            for k, v in req.spans.items():
                _span_s[k] += v
            for k, v in req.counters.items():
                _counts[k] += v


def _close(name: str, t0: int) -> None:
    t1 = _perf()
    req = _local.req
    if req is None:
        with _lock:
            _span_s[name] += (t1 - t0) / 1e9
        _ring.append((name, None, t0, t1))
        return
    spans = req.spans
    spans[name] = spans.get(name, 0.0) + (t1 - t0) / 1e9
    _ring.append((name, req.id, t0, t1))


class span:
    """`with span(name):` or `@span(name)`: the block's or each call's
    seconds, added to the open request (or the totals) and kept in the
    ring."""
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = _perf()
        return self

    def __exit__(self, *exc) -> bool:
        _close(self.name, self.t0)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = _perf()
            try:
                return fn(*a, **k)
            finally:
                _close(name, t0)
        return timed


class request:
    """`with request(op):` or `@request(op)`: a public call. The outermost
    on a thread opens a record with a fresh id and leaves it on close;
    inside an open request it joins that one."""
    __slots__ = ("op", "req")

    def __init__(self, op: str):
        self.op = op

    def __enter__(self):
        self.req = _open(self.op)
        return self

    def __exit__(self, *exc) -> bool:
        if self.req is not None:
            _done(self.req)
        return False

    def __call__(self, fn):
        op = self.op

        @functools.wraps(fn)
        def entry(*a, **k):
            req = _open(op)
            if req is None:
                return fn(*a, **k)
            try:
                return fn(*a, **k)
            finally:
                _done(req)
        return entry


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`, in the open request (or the totals)."""
    req = _local.req
    if req is None:
        with _lock:
            _counts[name] += n
        return
    c = req.counters
    c[name] = c.get(name, 0) + n


def now_ns() -> int:
    """Now on the spans' clock, in Unix-epoch ns."""
    return _perf() + _EPOCH


def last_request() -> dict | None:
    """This thread's newest finished request record (None before one)."""
    req = _local.last
    return None if req is None else req.record()


def totals() -> dict:
    """Process totals: requests closed by op, each span's seconds, each
    counter (a request's part once it has closed)."""
    _fold()
    with _lock:
        return {"requests": dict(_requests), "spans": dict(_span_s),
                "counters": dict(_counts)}


def recent() -> list:
    """The newest spans, oldest first: (name, request id or None, start_ns,
    end_ns), stamped in Unix-epoch ns."""
    return [(n, i, s + _EPOCH, e + _EPOCH) for n, i, s, e in list(_ring)]
