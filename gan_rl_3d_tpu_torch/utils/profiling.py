"""Profiling and the program's spans (gan_rl_3d_tpu/utils/profiling.py).

* ``trace(logdir)``: a context manager that runs ``torch.profiler`` over
  whatever runs inside it, host and (where a GPU is visible) device
  activity, and writes one Chrome trace, ``*.pt.trace.json``, under
  ``logdir`` (TensorBoard's profile plugin or Perfetto read it), and at
  exit ``spans.json`` beside it: the spans recorded inside the block, with
  their device seconds, and the per-name totals of the whole process
  (``span_records``, ``span_totals``). The kernels launched through
  ``ops._cuda`` show by their own names. The profiler holds every event in
  host memory until the end: trace a short run.
* ``span(name)``: one layer of the program, as a ``with`` block. Every
  span adds its count and host seconds to a per-name total, which is all
  it does while no profiler records (set-up runs before any profiler
  starts, so its spans are read from the totals). While ``torch.profiler``
  records, a span also opens a ``record_function`` range of its name, so
  that it lies on the trace's clock beside the device events, and keeps a
  record: its name, its parent span, its request (the index of the
  outermost span it lies in: the served call or the training step), its
  start and host seconds and, where CUDA is in use, a pair of CUDA events
  on the current stream. The events are resolved into device seconds (the
  stream's time between them, idle time included) only when the records
  are read, so a span never waits for the device.
* ``backward_spans``: one backward pass split at autograd hooks on the
  tensors that bound each layer, as records with ``phase: "backward"``
  (autograd's own events name the operations in the trace, so these open
  no range; their start and host seconds place them on its clock).

Span names start with ``serve.``, ``ae.`` or ``setup.``, which no kernel's
name does: the ranges' device-side copies in a trace are told from the
kernels by that.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

Tensor = torch.Tensor

# name -> [count, host seconds], over the whole process
_TOTALS: Dict[str, list] = {}
# the records kept while a profiler records, in the order they opened
_RECORDS: List[dict] = []
# the records of the spans open now, innermost last
_OPEN: List[dict] = []
# timing events of resolved records, for reuse
_POOL: List[torch.cuda.Event] = []
_REQUESTS = [0]


def _event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, where CUDA is in
    use."""
    if not torch.cuda.is_initialized():
        return None
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _add(name: str, seconds: float) -> None:
    total = _TOTALS.get(name)
    if total is None:
        _TOTALS[name] = [1, seconds]
    else:
        total[0] += 1
        total[1] += seconds


def _record(name: str, **fields) -> dict:
    parent = _OPEN[-1] if _OPEN else None
    if parent is None:
        request = _REQUESTS[0]
        _REQUESTS[0] += 1
    else:
        request = parent["request"]
    rec = {"name": name, "parent": parent and parent["name"],
           "request": request, "t_start": None, "host_s": None,
           "device_s": None, "events": None, **fields}
    _RECORDS.append(rec)
    return rec


class span:
    """``with span(name):`` times one layer of the program (module
    docstring)."""

    __slots__ = ("name", "_t0", "_rec", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._rec = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
            self._rec = _record(self.name)
            self._rec["events"] = (_event(), None)
            _OPEN.append(self._rec)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        _add(self.name, seconds)
        rec = self._rec
        if rec is not None:
            rec["t_start"], rec["host_s"] = self._t0, seconds
            rec["events"] = (rec["events"][0], _event())
            _OPEN.pop()
            self._range.__exit__(*exc)


@contextlib.contextmanager
def backward_spans(bounds: Sequence[Tuple[str, Tensor]], last: str
                   ) -> Iterator[None]:
    """Split the backward pass run inside the block into spans: from its
    start to the first tensor's gradient ``bounds[0][0]``, from there to
    the next tensor's, and so on, and from the last tensor's gradient to
    the end, ``last``. Each boundary is a CUDA event recorded by a hook on
    the tensor, on the stream the backward pass runs on; the hooks return
    nothing, so no gradient changes. Only while a profiler records; a
    tensor that gets no gradient marks no boundary, and its segment goes
    to the next one's name."""
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    marks = [(None, _event(), time.perf_counter())]

    def mark(name):
        def hook(grad):
            marks.append((name, _event(), time.perf_counter()))
        return hook

    handles = [t.register_hook(mark(name)) for name, t in bounds]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        marks.append((last, _event(), time.perf_counter()))
        for (_, ev0, t0), (name, ev1, t1) in zip(marks, marks[1:]):
            rec = _record(name, phase="backward")
            rec["t_start"], rec["host_s"] = t0, t1 - t0
            rec["events"] = (ev0, ev1)


def span_records() -> List[dict]:
    """The records kept while a profiler recorded, as dictionaries of
    name, parent, request, t_start (``time.perf_counter`` at the start),
    host_s, device_s (None without CUDA) and, for backward segments,
    phase. device_s is the time between the span's two events on the
    stream, idle time included. Waits for the device once to resolve
    the device seconds."""
    open_now = {id(r) for r in _OPEN}
    pending = [r for r in _RECORDS
               if r["events"] is not None and id(r) not in open_now]
    if any(r["events"][0] is not None for r in pending):
        torch.cuda.synchronize()
    freed: Dict[int, torch.cuda.Event] = {}
    for r in pending:
        start, end = r["events"]
        if start is not None and end is not None:
            r["device_s"] = start.elapsed_time(end) * 1e-3
            # backward segments share their boundary events
            freed[id(start)], freed[id(end)] = start, end
        r["events"] = None
    _POOL.extend(freed.values())
    return [{k: v for k, v in r.items() if k != "events"} for r in _RECORDS]


def span_totals() -> Dict[str, dict]:
    """Every span's count and host seconds over the whole process."""
    return {k: {"count": n, "host_s": s} for k, (n, s) in _TOTALS.items()}


def clear_spans() -> None:
    """Drop the kept records and start the request count again; the
    totals stay."""
    span_records()
    _RECORDS.clear()
    _REQUESTS[0] = 0


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the block into a Chrome trace and ``spans.json`` under
    ``logdir``; with ``enabled=False`` run it untouched and write
    nothing."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear_spans()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            yield
    finally:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({"records": span_records(), "totals": span_totals()},
                      f, indent=1)
        clear_spans()
