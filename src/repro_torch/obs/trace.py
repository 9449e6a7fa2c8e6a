"""Host-side span tracing for the consensus runtime.

One ``Tracer`` records named wall-clock spans (``stats`` / ``segment`` /
``snapshot`` / ``restore`` / caller-defined names) as flat dicts sharing
one clock (``time.perf_counter``, the same clock ``timed`` uses, so
timings and trace spans are directly comparable).  ``export`` writes two
artifacts:

  trace.json   Chrome trace event format (``ph: "X"`` complete events,
               microsecond timestamps), loadable in Perfetto or
               chrome://tracing.  The event fields are the reference's
               (``repro.obs.trace``), so either package's
               ``validate_trace`` reads the other's file.
  spans.jsonl  one span per line for grepping / pandas.

Activation is a dynamically-scoped global: ``with use(tracer): ...``
installs the tracer, and instrumented call sites do

    with span("segment", iters=n):
        ...

``span(...)`` returns a shared ``contextlib.nullcontext()`` when no
tracer is installed, so the cost of an instrumentation point with tracing
off is one function call and a global read: nothing is allocated and no
clock is read.  The device-side half of that guarantee is the
``cfg.telemetry`` gate in ``repro_torch.core.engine``.

CUDA launches return before the device has finished, so instrumented
sites call :func:`block_until_ready` on their outputs inside the span,
only while a tracer is installed: a span then covers the device work, not
the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch

_CLOCK = time.perf_counter


def block_until_ready(tree) -> None:
    """Wait for the device work behind every CUDA tensor in ``tree`` (any
    nesting of tuples, lists, dicts and NamedTuples): one
    ``torch.cuda.synchronize`` per device met.  CPU tensors need no wait."""
    devices = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for device in devices:
        torch.cuda.synchronize(device)


def timed(fn, *args, repeats: int = 1, **kwargs):
    """Run fn once (kernel builds, first-call costs), then time `repeats`
    executions, each waited for on the device."""
    out = fn(*args, **kwargs)
    block_until_ready(out)
    t0 = _CLOCK()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
        block_until_ready(out)
    dt = (_CLOCK() - t0) / repeats
    return out, dt


class Tracer:
    """Records spans relative to its construction time (µs)."""

    def __init__(self) -> None:
        self.spans: list[dict] = []
        self._t0 = _CLOCK()
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = _CLOCK()
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            t1 = _CLOCK()
            self.spans.append({
                "name": name,
                "ts": (t0 - self._t0) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "depth": self._depth,
                "args": args,
            })

    def trace_events(self) -> list[dict]:
        """Chrome trace event format rows (complete ``ph: "X"`` events)."""
        pid = os.getpid()
        return [
            {
                "name": s["name"],
                "ph": "X",
                "ts": s["ts"],
                "dur": s["dur"],
                "pid": pid,
                "tid": 0,
                "args": s["args"],
            }
            for s in sorted(self.spans, key=lambda s: (s["ts"], -s["dur"]))
        ]

    def export(self, trace_dir) -> dict:
        """Write trace.json + spans.jsonl under ``trace_dir``; returns
        ``{"trace": path, "spans": path}``."""
        trace_dir = Path(trace_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
        trace_path = trace_dir / "trace.json"
        spans_path = trace_dir / "spans.jsonl"
        with trace_path.open("w") as f:
            json.dump(
                {"traceEvents": self.trace_events(),
                 "displayTimeUnit": "ms"},
                f,
            )
        with spans_path.open("w") as f:
            for s in self.spans:
                f.write(json.dumps(s) + "\n")
        return {"trace": trace_path, "spans": spans_path}


_ACTIVE: Tracer | None = None
_NULL = contextlib.nullcontext()


def current() -> Tracer | None:
    """The installed tracer, or None when tracing is off."""
    return _ACTIVE


@contextlib.contextmanager
def use(tracer: Tracer | None):
    """Install ``tracer`` for the dynamic extent of the with-block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


def span(name: str, **args):
    """A span on the installed tracer, or a shared no-op context when
    tracing is off (no allocation, no clock)."""
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.span(name, **args)


def validate_trace(path) -> int:
    """Check a trace.json loads and its spans nest properly.

    Spans on one (pid, tid) track must form a forest: any two either
    are disjoint in time or one contains the other.  Returns the event
    count; raises ``ValueError`` on malformed traces.
    """
    with Path(path).open() as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    tracks: dict[tuple, list[dict]] = {}
    for e in events:
        if e.get("ph") != "X":
            raise ValueError(f"unexpected event phase: {e.get('ph')!r}")
        if not isinstance(e.get("name"), str):
            raise ValueError("event missing name")
        if e.get("dur", -1.0) < 0 or e.get("ts", -1.0) < 0:
            raise ValueError(f"negative ts/dur in {e.get('name')!r}")
        tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    eps = 1e-3  # µs slack for clock rounding at span boundaries
    for track in tracks.values():
        stack: list[float] = []  # open end-times
        for e in sorted(track, key=lambda e: (e["ts"], -e["dur"])):
            start, end = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1] <= start + eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                raise ValueError(
                    f"span {e['name']!r} overlaps its parent without nesting"
                )
            stack.append(end)
    return len(events)
