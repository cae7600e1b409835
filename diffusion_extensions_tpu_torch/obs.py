"""Spans and counters of the port: where a step's time goes, on the host
and on the card, and how often things happen.

``span(name)`` is a context manager around a stretch of work.  Spans are off
by default: then ``span()`` checks one flag and returns a shared no-op
context, and records, allocates and launches nothing.  ``enable()`` turns
them on; call it before a step is captured in a CUDA graph, since a graph
holds only what its capture ran.  On, a span records its name, the span
around it and its host start and end (``time.perf_counter_ns``), and while
``torch.profiler`` runs it also opens a ``record_function("dxt::<name>")``
range, which puts the host spans on the device trace's clock.

On a card, a device span (``device=True``, the default) also stamps the
device's clock into a ring in device memory at its start and end
(``csrc/obs_stamp.cu``, one thread reading ``%globaltimer``).  The ring's
row is a counter on the device that the outermost device span's end moves
on, so each replay of a captured step writes a row of its own; ``ROWS``
rows are kept and older ones are dropped (``snapshot()`` says how many).
An end is written by the next stamp on the stream (the next device span's
start, or the end of a span around it), so a span whose end and the next
span's start coincide costs one stamp there; device work issued after a
span closes and before that stamp counts to the span that closed, unless
the span was opened with ``flush=True``, whose end is stamped at once.  The
stamp kernels show in a device trace under their own name.  Without a card
spans keep host times only.  The stamp library is built and loaded by
``enable()`` on a CUDA device only.

``count(name, n)`` counters always count, spans on or off: an integer add.
A count made inside a captured graph is made once, at capture, however
often the graph replays.  ``device_count(names, values)`` counters count
on the device: an add of a tensor of integers into a buffer beside the
data, which a captured graph makes on every replay; ``snapshot()`` reads
them with the others.  The buffer is made by the first call, which runs
outside a capture.

Spans and counters are the process's; one thread opens spans.
``snapshot()`` reads them, ``reset()`` clears them; ``durations_ms``,
``gaps_us``, ``host_ns``, ``self_ns`` and ``summary`` read a snapshot.

``capture_count(prefix)`` counts a block's share of a CUDA graph while the
graph is captured: ``<prefix>.graph_kernels`` (its kernel, copy and fill
nodes, stamps left out) and ``<prefix>.captures``.
"""
from __future__ import annotations

import ctypes
import statistics
import time
from contextlib import contextmanager, nullcontext

import torch

__all__ = ["ROWS", "SLOTS", "DEVICE_COUNTERS", "span", "count", "device_count", "counter", "enable",
           "disable", "enabled", "reset", "snapshot", "stamp_ref", "decode", "durations_ms", "gaps_us",
           "host_ns", "self_ns", "summary", "graph_kernels", "capture_count"]

ROWS = 16384  # device rows kept (one a step; a 51 s window of aircraft has ~6,400); the ring has one more
SLOTS = 32  # a start and an end slot for each of 16 device spans
MAX_MERGE = 4  # slots one stamp writes (the kernel's kMaxSlots)
DEVICE_COUNTERS = 16  # places in a device's buffer of counters

_NOOP = nullcontext()
_on = False
_counters: dict[str, int] = {}
_records: list[list] = []  # [name, parent record or -1, start_ns, end_ns or None]
_open: list[int] = []  # records of the open spans, innermost last
_depth = 0  # open device spans
_pending: list[int] = []  # end slots that the next stamp writes
_slots: dict[str, int] = {}  # device span -> its start slot (its end slot is the next)
_ring: torch.Tensor | None = None  # (ROWS + 1, SLOTS) int64 on the card
_row: torch.Tensor | None = None  # (1,) int64: rows begun
_launch = None  # launch(slots, advance): one stamp kernel on the current stream
_device_places: dict[str, int] = {}  # device counter -> its place in a device's buffer
_device_counts: dict[torch.device, torch.Tensor] = {}  # (DEVICE_COUNTERS,) int64 on each device


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def device_count(names: tuple, values: torch.Tensor) -> None:
    """Add ``values`` (one integer a name, on the device) to the device
    counters ``names``: one add on the device, also on every replay of a
    captured graph.  The names of one call take neighbouring places, so
    they are always counted together."""
    places = [_device_places.get(n) for n in names]
    if None in places:
        if any(p is not None for p in places) or len(_device_places) + len(names) > DEVICE_COUNTERS:
            raise RuntimeError(f"device counters {names} do not fit beside {sorted(_device_places)}")
        for n in names:
            _device_places[n] = len(_device_places)
    first = _device_places[names[0]]
    if [_device_places[n] for n in names] != list(range(first, first + len(names))):
        raise RuntimeError(f"device counters {names} were counted apart before")
    buf = _device_counts.get(values.device)
    if buf is None:
        if values.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("device counters are made outside a capture: run a step eagerly first")
        buf = _device_counts[values.device] = torch.zeros(DEVICE_COUNTERS, dtype=torch.int64,
                                                          device=values.device)
    buf[first:first + len(names)].add_(values)


def enabled() -> bool:
    return _on


def span(name: str, device: bool = True, flush: bool = False):
    """A span around the ``with`` block; ``device=False`` keeps host times
    only (a span around host work, or around a graph's replay);
    ``flush=True`` stamps a device span's end at once, where device work
    that no span of its own holds follows inside a span around it."""
    if not _on:
        return _NOOP
    return _Span(name, device and _ring is not None, flush)


class _Span:
    __slots__ = ("name", "device", "flush", "index", "range")

    def __init__(self, name: str, device: bool, flush: bool = False):
        self.name, self.device, self.flush, self.range = name, device, flush, None

    def __enter__(self):
        global _depth
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.autograd.profiler.record_function("dxt::" + self.name)
            self.range.__enter__()
        self.index = len(_records)
        _records.append([self.name, _open[-1] if _open else -1, time.perf_counter_ns(), None])
        _open.append(self.index)
        if self.device:
            _stamp([*_pending, _slot(self.name)], False)
            _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth
        if self.device:
            _depth -= 1
            _pending.append(_slot(self.name) + 1)
            if _depth == 0 or self.flush:
                _stamp(list(_pending), _depth == 0)
        _records[self.index][3] = time.perf_counter_ns()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


def _slot(name: str) -> int:
    if name not in _slots:
        if 2 * len(_slots) >= SLOTS:
            raise RuntimeError(f"more than {SLOTS // 2} device spans: {sorted(_slots)} and {name}")
        _slots[name] = 2 * len(_slots)
    return _slots[name]


def _stamp(slots: list, advance: bool) -> None:
    """Stamp the device's clock into ``slots`` of the current row, in
    launches of at most MAX_MERGE slots; ``advance`` moves to the next row."""
    _pending.clear()
    for i in range(0, max(len(slots), 1), MAX_MERGE):
        _launch(slots[i:i + MAX_MERGE], advance and i + MAX_MERGE >= len(slots))
        count("obs.stamps")


def stamp_ref(ring: torch.Tensor, row: torch.Tensor, slots: list, advance: bool, now: int) -> None:
    """The stamp kernel's arithmetic on the CPU: ``now`` into ``slots`` of
    row ``row % rows`` of ``ring`` (rows, slots); with ``advance`` the next
    row is zeroed and ``row`` moves on."""
    rows = ring.shape[0]
    r = int(row[0])
    for s in slots:
        ring[r % rows, s] = now
    if advance:
        ring[(r + 1) % rows] = 0
        row[0] = r + 1


def decode(ring: torch.Tensor, rows_begun: int, slots: dict) -> dict:
    """The finished rows of a ring (on the CPU) in the order they were
    written: ``{"first_row", "rows", "dropped", "spans": {name: {"start":
    [...], "end": [...]}}}``, 0 where a row holds no stamp of the span.  A
    ring of n lines keeps n - 1 rows: the line of the row in progress was
    zeroed when it began."""
    keep = min(rows_begun, ring.shape[0] - 1)
    first = rows_begun - keep
    lines = ring[torch.arange(first, rows_begun) % ring.shape[0]]
    return {"first_row": first, "rows": keep, "dropped": first,
            "spans": {name: {"start": lines[:, s].tolist(), "end": lines[:, s + 1].tolist()}
                      for name, s in slots.items()}}


def enable(device=None) -> None:
    """Turn spans on.  On a CUDA device (``device``, or the current one
    when None and a card is present) build and load the stamp kernel and
    make the ring; elsewhere spans keep host times only."""
    global _on, _ring, _row, _launch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and _ring is None:
        from .ops._build import CSRC, build_library

        lib, _, _ = build_library(CSRC / "obs_stamp.cu")
        fn = lib.obs_stamp_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(slots: list, advance: bool) -> None:
            err = fn(_ring.data_ptr(), _row.data_ptr(), ROWS + 1, SLOTS, len(slots),
                     *slots, *[0] * (MAX_MERGE - len(slots)), int(advance),
                     torch.cuda.current_stream(_ring.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"obs_stamp kernel launch failed: cudaError {err}")

        _launch = launch
        _ring = torch.zeros((ROWS + 1, SLOTS), dtype=torch.int64, device=device)
        _row = torch.zeros(1, dtype=torch.int64, device=device)
        _stamp([], False)  # loads the kernel before any capture
        torch.cuda.synchronize(device)
    _on = True


def disable() -> None:
    """Turn spans off (a graph captured with spans on keeps its stamps)."""
    global _on
    _on = False


def reset() -> None:
    """Clear the spans (host records and the ring) and the counters."""
    global _depth
    if _open:
        raise RuntimeError(f"reset inside open spans: {[_records[i][0] for i in _open]}")
    _records.clear()
    _pending.clear()
    _depth = 0
    _counters.clear()
    for buf in _device_counts.values():
        buf.zero_()  # in place: a captured graph holds its address
    if _ring is not None:
        _ring.zero_()
        _row.zero_()


def snapshot() -> dict:
    """``{"host": [[name, parent, start_ns, end_ns], ...], "device": decode()
    of the ring or None, "counters": {...}}``.  ``parent`` is the index of
    the enclosing span's record (-1: none); ``end_ns`` None: still open.
    Waits for the card.  ``counters`` holds the device counters that read
    more than 0 too."""
    device = None
    if _ring is not None:
        if _ring.is_cuda:
            torch.cuda.synchronize(_ring.device)
        device = decode(_ring.cpu(), int(_row.item()), _slots)
    counters = dict(_counters)
    for buf in _device_counts.values():
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        values = buf.cpu().tolist()
        for name, place in _device_places.items():
            if values[place]:  # as a host counter never counted, one that reads 0 is left out
                counters[name] = counters.get(name, 0) + values[place]
    return {"host": [list(r) for r in _records], "device": device, "counters": counters}


def durations_ms(snap: dict, name: str) -> list:
    """Device ms of span ``name`` in each row that stamped both its ends."""
    spans = (snap["device"] or {"spans": {}})["spans"]
    if name not in spans:
        return []
    s = spans[name]
    return [(e - b) / 1e6 for b, e in zip(s["start"], s["end"]) if b and e]


def gaps_us(snap: dict, name: str = "train.step") -> list:
    """Device us from span ``name``'s end in one row to its start in the
    next: what runs between two replayed steps."""
    spans = (snap["device"] or {"spans": {}})["spans"]
    if name not in spans:
        return []
    s = spans[name]
    return [(b - e) / 1e3 for e, b in zip(s["end"], s["start"][1:]) if e and b]


def host_ns(snap: dict, name: str) -> list:
    return [e - s for n, _, s, e in snap["host"] if n == name and e is not None]


def self_ns(snap: dict) -> list:
    """Each host record's duration less its children's (spans nest, so
    that is the part of its interval no child covers); None while open."""
    out = [None if e is None else e - s for _, _, s, e in snap["host"]]
    for i, (_, parent, _, _) in enumerate(snap["host"]):
        if parent >= 0 and out[parent] is not None and out[i] is not None:
            out[parent] -= snap["host"][i][3] - snap["host"][i][2]
    return out


def _median(values: list):
    return statistics.median(values) if values else None


def summary(snap: dict) -> dict:
    """Medians: device ms a row of each device span, the device us between
    two rows of ``train.step``, host us of each host span; and the rows,
    rows dropped and counters."""
    device = snap["device"] or {"spans": {}, "rows": 0, "dropped": 0}
    host = {}
    for name, _, s, e in snap["host"]:
        if e is not None:
            host.setdefault(name, []).append((e - s) / 1e3)
    return {"device_ms": {n: _median(durations_ms(snap, n)) for n in device["spans"]},
            "between_steps_us": _median(gaps_us(snap)),
            "host_us": {n: _median(v) for n, v in host.items()},
            "rows": device["rows"], "dropped": device["dropped"], "counters": snap["counters"]}


_CU_STREAM_CAPTURE_STATUS_ACTIVE = 1
_CU_GRAPH_NODE_TYPES_RUN = (0, 1, 2)  # kernel, memcpy, memset nodes
_libcuda = None


def _cu(fn_name: str, *args) -> None:
    err = getattr(_libcuda, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUresult {err}")


def graph_kernels(stream: torch.cuda.Stream) -> int:
    """The device operations of the graph being captured on ``stream``:
    its kernel, copy and fill nodes (a replay runs a copy node as a kernel
    of its own), read through ``libcuda`` (``cuStreamGetCaptureInfo``,
    ``cuGraphGetNodes``)."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    status, graph, n = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
    handle = ctypes.c_void_p(stream.cuda_stream)
    if hasattr(_libcuda, "cuStreamGetCaptureInfo_v2"):
        _cu("cuStreamGetCaptureInfo_v2", handle, ctypes.byref(status), None, ctypes.byref(graph), None, None)
    else:
        _cu("cuStreamGetCaptureInfo_v3", handle, ctypes.byref(status), None, ctypes.byref(graph), None, None,
            None)
    if status.value != _CU_STREAM_CAPTURE_STATUS_ACTIVE:
        raise RuntimeError("graph_kernels: the stream is not capturing")
    _cu("cuGraphGetNodes", graph, None, ctypes.byref(n))
    if n.value == 0:  # an array of no nodes is refused (CUDA_ERROR_INVALID_VALUE)
        return 0
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        _cu("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value in _CU_GRAPH_NODE_TYPES_RUN
    return kernels


@contextmanager
def capture_count(prefix: str):
    """Around a block: only while the current stream is being captured,
    add to ``<prefix>.graph_kernels`` the kernel, copy and fill nodes the
    block added to the graph, its stamps left out, and one to
    ``<prefix>.captures``.  Outside a capture it counts nothing."""
    if not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()):
        yield
        return
    stream, stamps = torch.cuda.current_stream(), counter("obs.stamps")
    nodes = graph_kernels(stream)
    yield
    count(f"{prefix}.graph_kernels", graph_kernels(stream) - nodes - (counter("obs.stamps") - stamps))
    count(f"{prefix}.captures")
