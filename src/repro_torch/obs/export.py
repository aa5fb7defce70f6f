"""JSONL span export + round-trip loader, the reference's ``obs/export.py``
unchanged.

One JSON object per line, one line per CLOSED span (children close before
their parent, so a consumer streaming the file sees leaves first).  Each
record is flat — ``span_id``/``parent_id`` encode the tree — so the file
can be tailed, grepped, and merged across processes.  :func:`load_jsonl`
rebuilds the span forest for offline analysis and for the round-trip
tests.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

__all__ = ["JsonlExporter", "load_jsonl", "SpanRecord"]


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)          # numpy scalars, 0-d arrays
    except Exception:
        return repr(v)


class JsonlExporter:
    """Append-mode JSONL writer; thread-safe, flushes per span so traces
    survive a crashed run."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8")

    def write_span(self, sp) -> None:
        rec = {
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "name": sp.name,
            "t0": sp.t0,
            "dur_s": sp.dur_s,
            "thread": sp.thread,
            "attrs": {k: _jsonable(v) for k, v in sp.attrs.items()},
        }
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class SpanRecord:
    """A span rebuilt from JSONL: same tree-shape API as a live Span."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "dur_s", "thread",
                 "attrs", "children")

    def __init__(self, rec: dict) -> None:
        self.span_id = rec["span_id"]
        self.parent_id = rec.get("parent_id")
        self.name = rec["name"]
        self.t0 = rec["t0"]
        self.dur_s = rec["dur_s"]
        self.thread = rec.get("thread")
        self.attrs = dict(rec.get("attrs", {}))
        self.children: list[SpanRecord] = []

    def find(self, name: str) -> list["SpanRecord"]:
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out

    def total_child_seconds(self) -> float:
        return sum(c.dur_s for c in self.children)


def load_jsonl(path: str) -> list[SpanRecord]:
    """Rebuild the span forest from a JSONL trace: returns root spans
    with children re-attached (ordered by close time, i.e. file order)."""
    by_id: dict[int, SpanRecord] = {}
    order: list[SpanRecord] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            sp = SpanRecord(json.loads(line))
            by_id[sp.span_id] = sp
            order.append(sp)
    roots: list[SpanRecord] = []
    for sp in order:
        parent: Optional[SpanRecord] = (
            by_id.get(sp.parent_id) if sp.parent_id is not None else None)
        if parent is not None:
            parent.children.append(sp)
        else:
            roots.append(sp)
    return roots
