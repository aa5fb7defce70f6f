"""Structured span tracer for the SVD pipeline, after the reference's
``obs/trace.py``.

A :class:`Span` is a named, attributed interval on the host monotonic
clock (``time.perf_counter``).  Spans nest per thread (a thread-local
stack), carry key/value attributes (``n``, ``bw``, ``dtype``, ``fuse``,
``backend``, ``tier``, ...), and **fence** at close: a span that was handed
a CUDA tensor (:meth:`Span.fence`) calls ``torch.cuda.synchronize()`` on
that tensor's device before its closing timestamp, so device work launched
inside the span is attributed to it and not to whichever later span first
reads a result on the host.  A CPU tensor needs no fence.

Two rules keep the tracer free and safe:

* **No ambient tracer, no cost.**  Instrumented code calls
  :func:`repro_torch.obs.span`, which returns one shared null span when no
  tracer is active: no synchronisation, no allocation.
* **No spans while a graph is captured or compiled.**  While
  ``torch.cuda.is_current_stream_capturing()`` (a CUDA graph capture,
  where a synchronisation is illegal) or ``torch.compiler.is_compiling()``
  (Dynamo tracing, where host times are trace times) is true,
  :meth:`Tracer.span` returns the null span.

Build and run: the reference splits a jitted call's first dispatch into a
``<name>/compile`` and a ``<name>/run`` span.  PyTorch has nothing to
lower; what a first dispatch here pays for is the ``nvcc`` build of the
kernels it launches.  :meth:`Tracer.jit_call` keeps the reference's name:
the first dispatch per (name, static arguments, argument shapes) runs
under a fenced ``<name>/run`` span, later ones plainly, and
``kernels/_build.py::load`` opens a ``build`` span (``kernel=<name>``)
around every build it performs, so the first dispatch's tree shows where
the build time went.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from typing import Any, Callable, Optional

import torch

__all__ = [
    "Span",
    "Tracer",
    "current",
    "activated",
    "install",
    "span",
    "traced_jit_call",
]

_ids = itertools.count(1)


def _host_clean() -> bool:
    """True when host spans mean something: no CUDA graph is being captured
    on the current stream and torch.compile is not tracing."""
    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def _cuda_devices(value: Any, out: set) -> None:
    """The CUDA devices of the tensors in ``value`` (nested tuples, lists
    and dicts)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)


class Span:
    """One timed interval.  Use via ``tracer.span(...)`` as a context
    manager; closing fences registered CUDA tensors, records the duration,
    tags errors, and attaches the span to its parent (or the tracer's
    root list)."""

    __slots__ = ("name", "attrs", "children", "span_id", "parent_id",
                 "thread", "t0", "dur_s", "_tracer", "_fence")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.children: list[Span] = []
        self.span_id = next(_ids)
        self.parent_id: Optional[int] = None
        self.thread = threading.get_ident()
        self.t0 = 0.0
        self.dur_s = 0.0
        self._tracer = tracer
        self._fence: list[Any] = []

    def set(self, **attrs: Any) -> "Span":
        """Attach or overwrite attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def fence(self, value: Any) -> Any:
        """Register a tensor (or a tuple, list or dict of them) whose
        device work must finish before this span closes.  Returns value."""
        if value is not None:
            self._fence.append(value)
        return value

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._fence and exc_type is None:
            devices: set = set()
            _cuda_devices(self._fence, devices)
            for dev in devices:
                torch.cuda.synchronize(dev)
        self.dur_s = time.perf_counter() - self.t0
        if exc_type is not None:
            self.attrs["error"] = repr(exc)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # defensive: unwind mis-nested exits
            stack.remove(self)
        parent = stack[-1] if stack else None
        self._tracer._record(self, parent)
        return False                 # never swallow exceptions

    # ------------------------------------------------------------------

    def total_child_seconds(self) -> float:
        return sum(c.dur_s for c in self.children)

    def find(self, name: str) -> list["Span"]:
        """All descendants (and self) whose name matches, pre-order."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "dur_s": self.dur_s,
            "thread": self.thread,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def format(self, indent: int = 0, *, min_ms: float = 0.0) -> str:
        """Human-readable tree: name, duration, attrs — one line per span."""
        pad = "  " * indent
        attrs = " ".join(f"{k}={v}" for k, v in self.attrs.items())
        line = f"{pad}{self.name:<24s} {self.dur_s * 1e3:9.3f} ms"
        if attrs:
            line += f"  [{attrs}]"
        lines = [line]
        for c in self.children:
            if c.dur_s * 1e3 >= min_ms:
                lines.append(c.format(indent + 1, min_ms=min_ms))
        return "\n".join(lines)


class _NullSpan:
    """Shared no-op span: returned when no tracer is active or a graph is
    being captured or compiled.  Every method is a cheap no-op so
    instrumented code never branches on tracer presence."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs):
        return self

    def fence(self, value):
        return value


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects span trees (thread-safe) and optionally streams each
    closed span as one JSONL line.

    ``tracer.roots`` holds completed top-level spans (one tree per traced
    entry-point call, plus one per span opened on a thread with an empty
    stack, e.g. a serve dispatcher thread).
    """

    def __init__(self, name: str = "trace",
                 jsonl: Optional[str] = None) -> None:
        self.name = name
        self.roots: list[Span] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._dispatched: set = set()   # jit_call keys already run once
        self._jsonl_file = None
        if jsonl is not None:
            from repro_torch.obs.export import JsonlExporter
            self._jsonl_file = JsonlExporter(jsonl)

    # ------------------------------------------------------------------

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: Span, parent: Optional[Span]) -> None:
        if parent is not None:
            parent.children.append(sp)
        else:
            with self._lock:
                self.roots.append(sp)
        if self._jsonl_file is not None:
            self._jsonl_file.write_span(sp)

    def span(self, name: str, **attrs: Any):
        """Open a child span of the current thread's innermost span (or a
        new root).  Returns the null span while a CUDA graph is captured or
        torch.compile traces."""
        if not _host_clean():
            return _NULL_SPAN
        return Span(self, name, attrs)

    # ------------------------------------------------------------------
    # first dispatch

    @staticmethod
    def _shape_key(x: Any):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
        if isinstance(x, (tuple, list)):
            return ("seq", tuple(Tracer._shape_key(v) for v in x))
        return ("lit", x)

    def jit_call(self, name: str, fn: Callable, *args: Any,
                 **static_kwargs: Any) -> Any:
        """Call ``fn(*args, **static_kwargs)``; the first dispatch per
        (name, static arguments, argument shapes, dtypes and devices) runs
        under a fenced ``<name>/run`` span, where any kernel build it
        triggers shows as a ``build`` child; later dispatches run plainly.
        Unhashable arguments run plainly."""
        if not _host_clean():
            return fn(*args, **static_kwargs)
        try:
            key = (name, tuple(sorted(static_kwargs.items(), key=str)),
                   tuple(self._shape_key(a) for a in args))
            hash(key)
        except TypeError:
            return fn(*args, **static_kwargs)
        with self._lock:
            first = key not in self._dispatched
            self._dispatched.add(key)
        if not first:
            return fn(*args, **static_kwargs)
        with self.span(f"{name}/run") as sp:
            return sp.fence(fn(*args, **static_kwargs))

    # ------------------------------------------------------------------

    def format(self, *, min_ms: float = 0.0) -> str:
        with self._lock:
            roots = list(self.roots)
        return "\n".join(r.format(min_ms=min_ms) for r in roots)

    def close(self) -> None:
        if self._jsonl_file is not None:
            self._jsonl_file.close()


# ----------------------------------------------------------------------
# ambient ("current") tracer plumbing

_current: contextvars.ContextVar[Optional[Tracer]] = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)
_global: Optional[Tracer] = None


def current() -> Optional[Tracer]:
    """The active tracer: context-local first, process-global fallback."""
    tr = _current.get()
    return tr if tr is not None else _global


@contextlib.contextmanager
def activated(tracer: Optional[Tracer]):
    """Make ``tracer`` the ambient tracer within this context (and
    thread).  ``activated(None)`` is a no-op passthrough."""
    if tracer is None:
        yield None
        return
    token = _current.set(tracer)
    try:
        yield tracer
    finally:
        _current.reset(token)


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Set (or clear, with None) the process-global fallback tracer —
    visible to ALL threads, unlike :func:`activated`.  Returns the
    previous global."""
    global _global
    prev, _global = _global, tracer
    return prev


def span(name: str, **attrs: Any):
    """A span on the ambient tracer, or the shared null span when none is
    active (or a graph is being captured or compiled)."""
    tr = current()
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, **attrs)


def traced_jit_call(name: str, fn: Callable, *args: Any,
                    **static_kwargs: Any) -> Any:
    """:meth:`Tracer.jit_call` on the ambient tracer, or a plain call when
    none is active."""
    tr = current()
    if tr is None:
        return fn(*args, **static_kwargs)
    return tr.jit_call(name, fn, *args, **static_kwargs)
