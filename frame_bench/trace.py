"""Reading a `torch.profiler` trace of the traced frames.

`Trace.read(prof, frames)` keeps, from the profiler's raw events: the
harness's own spans (record_function ranges named "fb.<span>"), the
host's CUDA runtime calls, the host's other operations (for naming idle
gaps), and every device activity (kernels, copies, fills).  The window is
the first traced frame's start to the last one's end.  The busy time is
the union of the device activities' intervals inside it.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

SPAN_PREFIX = "fb."


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _kind(e) -> str:
    kind = getattr(e, "activity_type", None)
    return str(kind()) if callable(kind) else ""


@dataclass
class Trace:
    frames: int
    t0: int = 0  # ns, profiler clock
    t1: int = 0
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # name, start, end
    runtime: List[Tuple[str, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    host_ops: List[Tuple[str, int, int]] = field(default_factory=list)

    @classmethod
    def read(cls, prof, frames: int) -> "Trace":
        t = cls(frames)
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s = _start_ns(e)
            end = s + _dur_ns(e)
            if "CUDA" in str(e.device_type()):
                # Skip the device-side mirrors of host ranges, and waits.
                kind = _kind(e).lower()
                if name.startswith(SPAN_PREFIX) or "annotation" in kind or "sync" in kind:
                    continue
                t.device.append((name, s, end))
            elif name.startswith(SPAN_PREFIX):
                t.spans.append((name[len(SPAN_PREFIX):], s, end))
            elif name.startswith("cu") and ("runtime" in _kind(e) or "driver" in _kind(e)
                                            or not _kind(e)):
                t.runtime.append((name, s))
            else:
                t.host_ops.append((name, s, end))
        frames_ = [(s, e) for n, s, e in t.spans if n == "frame"]
        if frames_:
            t.t0 = min(s for s, _ in frames_)
            t.t1 = max(e for _, e in frames_)
        t.device = [(n, max(s, t.t0), min(e, t.t1)) for n, s, e in t.device
                    if e > t.t0 and s < t.t1]
        t.runtime = [(n, s) for n, s in t.runtime if t.t0 <= s < t.t1]
        return t

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(v) for v in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, pick) -> float:
        """Seconds of device activity whose name `pick(name)` accepts
        (summed: overlapping activities each count)."""
        return sum(e - s for n, s, e in self.device if pick(n)) / 1e9

    def top_device_ops(self, n: int = 10):
        """The `n` device activities that took the most time, by name (cut
        to 160 characters), with their seconds over the traced frames."""
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name[:160]] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """Idle device time inside the window, summed by what the host was
        in at each gap's middle: the innermost harness span and, inside
        it, the innermost host operation."""
        edges = [(self.t0, self.t0)] + self.busy_intervals() + [(self.t1, self.t1)]
        by = defaultdict(int)
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                by[self._host_at((a + b) // 2)] += b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: int) -> str:
        def innermost(items):
            best = None
            for name, s, e in items:
                if s <= t < e and (best is None or s >= best[1]):
                    best = (name, s)
            return best[0] if best else None

        span = innermost([v for v in self.spans if v[0] != "frame"]) or "between frames"
        op = innermost(self.host_ops)
        return f"{span} / {op}" if op else span


def kernel_names(csrc: Path) -> Dict[str, List[str]]:
    """{source file name: names of the `__global__` functions it defines}."""
    return {p.name: _globals(p.read_text()) for p in sorted(csrc.glob("*.cu"))}


def _globals(src: str) -> List[str]:
    """The name after each `__global__`: past the return type and any
    attribute with its (nested) parentheses, the identifier that opens
    the parameter list or template arguments."""
    names = []
    for m in re.finditer(r"__global__", src):
        i = m.end()
        while True:
            w = re.compile(r"\s*(\w+)\s*").match(src, i)
            if w is None:
                break
            i = w.end()
            if w.group(1).startswith("__") and src[i:i + 1] == "(":
                depth = 0
                while True:  # skip the attribute's arguments
                    depth += {"(": 1, ")": -1}.get(src[i], 0)
                    i += 1
                    if depth == 0:
                        break
            elif src[i:i + 1] and src[i] in "(<" and w.group(1) != "void":
                names.append(w.group(1))
                break
    return names


def matcher(names):
    """A test of a device activity's name against kernel names, by word."""
    pats = [re.compile(rf"(^|[^\w]){re.escape(k)}([^\w]|$)") for k in names]
    return lambda name: any(p.search(name) for p in pats)
