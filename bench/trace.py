"""What a ``--trace 1`` run reads from the profiler's timeline.

The window runs under ``torch.profiler`` (CPU and CUDA activities), the
whole loop inside a ``bench.window`` annotation and each call inside a
``bench.call`` one.  The trace is exported as Chrome-trace JSON and
reduced here to plain numbers:

* ``busy_s``: the union of the device's intervals (kernels, copies,
  sets) inside the window, so overlapping streams count once;
* ``device_s``: device seconds by the operation's short name, of the
  operations launched inside calls (matched to their launch by the
  trace's correlation ids; an operation whose launch the trace does not
  show counts as the program's), so the harness's own read-back
  between calls is left out;
* ``idle_gaps``: the device's idle seconds by what the host was doing
  (the innermost host operation open at the gap's middle; else "python
  in a call", the program's own Python, or "between calls", the
  harness's).
"""

from __future__ import annotations

import bisect
import json
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

#: The port's hand-written kernels (``kernels/csrc/*.cu``), by short name.
PORT_KERNEL = re.compile(r"^(simplex|hyperbox|revised|pdhg)(_[a-z]+)?_kernel$")


def short_name(name: str) -> str:
    """``void (anonymous namespace)::simplex_cluster_kernel<float>(float*, ...)`` ->
    ``simplex_cluster_kernel``: no return type, anonymous namespace, template or
    parameters."""
    name = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_gaps: Dict[str, float] = field(default_factory=dict)

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose short name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))

    def port_seconds(self) -> float:
        return sum(s for name, s in self.device_s.items() if PORT_KERNEL.match(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=[[k, v] for k, v in gaps])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def _host_at(points: List[float], events: List[Tuple[float, float, str]]) -> List[Optional[str]]:
    """The innermost host event open at each of the sorted ``points``."""
    out: List[Optional[str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name), nested
    i = 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            lo, hi, name = events[i]
            while stack and stack[-1][0] <= lo:
                stack.pop()
            stack.append((hi, name))
            i += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        out.append(stack[-1][1] if stack else None)
    return out


def reduce(events: List[dict]) -> Trace:
    """Reduce Chrome-trace events to a :class:`Trace` (times in the trace's microseconds)."""
    window = [e for e in events if e.get("name") == "bench.window" and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace has no bench.window annotation")
    w = window[0]
    w_lo, w_hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    calls, device, host = [], [], []
    launched = {}  # correlation id -> host time of the runtime call
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = float(e["ts"])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo = float(e["ts"])
        hi = lo + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            lo, hi = max(lo, w_lo), min(hi, w_hi)
            if hi > lo:
                device.append((lo, hi, short_name(e.get("name", "?")),
                               launched.get(e.get("args", {}).get("correlation"))))
        elif cat in HOST_CATS and w_lo <= lo <= w_hi and e.get("tid") == w.get("tid"):
            if e.get("name") == "bench.call":
                calls.append((lo, hi))
            elif e.get("name") != "bench.window":
                host.append((lo, hi, e.get("name", "?")))
    calls.sort()
    starts = [c[0] for c in calls]

    def in_call(t: float) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= calls[k][1]

    device_s: Counter = Counter()
    for lo, hi, name, launch in device:
        if launch is None or in_call(launch):
            device_s[name] += (hi - lo) * 1e-6
    busy = _union([(lo, hi) for lo, hi, _, _ in device])
    gaps, edge = [], w_lo
    for lo, hi in busy + [(w_hi, w_hi)]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    host.sort(key=lambda h: (h[0], -h[1]))
    mids = [(lo + hi) / 2 for lo, hi in gaps]
    idle: Counter = Counter()
    for (lo, hi), mid, name in zip(gaps, mids, _host_at(mids, host)):
        if name is None:  # no operation open: plain Python, the program's or the harness's
            name = "python in a call" if in_call(mid) else "between calls"
        idle[name] += (hi - lo) * 1e-6
    return Trace(window_s=(w_hi - w_lo) * 1e-6,
                 busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
                 calls=len(calls), device_s=dict(device_s),
                 idle_gaps=dict(idle))


def read(path) -> Trace:
    with open(path) as fh:
        data = json.load(fh)
    return reduce(data["traceEvents"] if isinstance(data, dict) else data)
