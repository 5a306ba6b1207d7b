"""Tracing spans: nestable, thread-safe, Chrome/Perfetto-exportable
(port of ``repro.obs.trace``).

``span("sweep.launch", **attrs)`` brackets one phase:

* wall time comes from ``perf_counter`` pairs;
* **device work is synced before the span closes** when the caller
  hands the span its output (``sync=``, any nest of tuples, lists and
  dicts): CUDA launches return before the card has run them, so an
  unsynced bracket measures *enqueue*, not execution.  The sync records
  an event on the current stream of each CUDA device the output lives
  on and waits for that event — never for the whole device.  The span
  records both ``dispatch_s`` (time to the sync point) and ``dur``
  (wall including the wait);
* a span without ``sync=`` never synchronizes: the cluster pass's one
  device-to-host copy stays the only sync of a clustering;
* spans nest through a thread-local stack (each record carries its
  parent id), and the buffer is guarded by one lock;
* ``export_chrome_trace()`` emits the ``trace_event`` JSON that Chrome
  ``about:tracing`` and Perfetto load; ``enable(profiler_annotations=
  True)`` also wraps every span in ``torch.profiler.record_function``
  so the same names land inside ``torch.profiler`` captures.

Everything is **off by default**: with tracing disabled ``span()``
returns a shared no-op context manager.  ``force=True`` makes a span
measure (but not record) while tracing is off — what the pipeline's
``elapsed_s`` rides.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "span",
    "spans",
    "clear",
    "export_chrome_trace",
    "coverage",
    "Span",
    "SpanRecord",
]

_lock = threading.Lock()
_records: List["SpanRecord"] = []
_ids = itertools.count(1)
_tls = threading.local()

# epoch anchor so perf_counter timestamps are comparable across export
_T0_PERF = time.perf_counter()
_T0_EPOCH = time.time()


class _State:
    trace: bool = False
    profiler_annotations: bool = False


_state = _State()


@dataclass
class SpanRecord:
    """One closed span.  Times are seconds on the perf_counter clock."""

    name: str
    t0: float
    dur: float = 0.0
    dispatch_s: Optional[float] = None  # time to the sync point (dur - wait)
    span_id: int = 0
    parent_id: int = 0
    tid: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NullSpan:
    """Disabled-tracing fast path: no timing, no allocation per call."""

    __slots__ = ()
    dur = 0.0
    dispatch_s = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def sync_on(self, out):
        return self


_NULL = _NullSpan()


class Span:
    """Active span handle (context manager).  ``.dur`` is valid after
    exit; ``.set(**attrs)`` adds attributes mid-flight."""

    __slots__ = ("name", "attrs", "_sync", "_record", "_rec", "_ann")

    def __init__(self, name: str, sync=None, attrs=None, record: bool = True):
        self.name = name
        self.attrs = dict(attrs or {})
        self._sync = sync
        self._record = record
        self._rec: Optional[SpanRecord] = None
        self._ann = None

    @property
    def dur(self) -> float:
        return self._rec.dur if self._rec is not None else 0.0

    @property
    def dispatch_s(self) -> Optional[float]:
        return self._rec.dispatch_s if self._rec is not None else None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync_on(self, out) -> "Span":
        """Arrange for ``out`` (tensors, possibly nested in tuples, lists
        or dicts) to be synced at span exit."""
        self._sync = out
        return self

    def __enter__(self) -> "Span":
        rec = SpanRecord(self.name, 0.0, span_id=next(_ids), tid=threading.get_ident())
        st = _stack()
        rec.parent_id = st[-1].span_id if st else 0
        st.append(rec)
        self._rec = rec
        if _state.profiler_annotations:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        rec.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        if self._sync is not None:
            rec.dispatch_s = time.perf_counter() - rec.t0
            _block(self._sync)
        rec.dur = time.perf_counter() - rec.t0
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        st = _stack()
        if st and st[-1] is rec:
            st.pop()
        else:  # tolerate mis-nested exits rather than corrupt the stack
            try:
                st.remove(rec)
            except ValueError:
                pass
        rec.attrs = self.attrs
        if self._record:
            if exc_type is not None:
                rec.attrs = dict(rec.attrs, error=exc_type.__name__)
            with _lock:
                _records.append(rec)
        return False


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def _block(out) -> None:
    """Wait until the work that produced ``out``'s CUDA tensors is done:
    one event recorded on the current stream of each device they live
    on, then synchronized.  Host values (numpy arrays, numbers, CPU
    tensors) pass through."""
    for dev in _cuda_devices(out, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def span(name: str, *, sync=None, force: bool = False, **attrs):
    """Context manager bracketing one phase.

    ``sync=`` — tensors synced before the span closes (measure
    execution, not enqueue); the pre-sync time is ``dispatch_s``.
    ``force=True`` measures even when tracing is disabled (without
    appending to the buffer) so callers can read ``.dur``.
    """
    if not _state.trace and not force:
        return _NULL
    return Span(name, sync=sync, attrs=attrs, record=_state.trace)


def spans(name: Optional[str] = None) -> List[SpanRecord]:
    """Closed spans recorded so far (optionally filtered by name)."""
    with _lock:
        out = list(_records)
    if name is not None:
        out = [r for r in out if r.name == name]
    return out


def clear() -> None:
    with _lock:
        _records.clear()


def coverage(root: SpanRecord, records: Optional[List[SpanRecord]] = None) -> float:
    """Fraction of ``root``'s wall time covered by the union of its
    direct children's intervals (uninstrumented gaps pull it below 1)."""
    if root.dur <= 0:
        return 0.0
    records = spans() if records is None else records
    ivals = sorted((r.t0, r.t0 + r.dur) for r in records if r.parent_id == root.span_id)
    covered, cur_s, cur_e = 0.0, None, None
    for s, e in ivals:
        s, e = max(s, root.t0), min(e, root.t0 + root.dur)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered / root.dur


def export_chrome_trace(path: Optional[str] = None) -> dict:
    """Chrome/Perfetto ``trace_event`` JSON of every recorded span:
    complete ("X") events, microsecond timestamps on a common epoch
    base, attributes in ``args``.  Returns the dict (and writes it to
    ``path`` when given)."""
    pid = os.getpid()
    events = []
    for r in spans():
        args = dict(r.attrs, span_id=r.span_id, parent_id=r.parent_id)
        if r.dispatch_s is not None:
            args["dispatch_us"] = r.dispatch_s * 1e6
        events.append(
            {
                "name": r.name,
                "cat": r.name.split(".", 1)[0],
                "ph": "X",
                "ts": (_T0_EPOCH + (r.t0 - _T0_PERF)) * 1e6,
                "dur": r.dur * 1e6,
                "pid": pid,
                "tid": r.tid % 2**31,
                "args": {k: (v if isinstance(v, (int, float, bool, str)) else repr(v))
                         for k, v in args.items()},
            }
        )
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(doc))
    return doc
