"""The traced run: the window under ``torch.profiler`` and what the
per-layer readers see of it.

The benchmark's own spans (``record_function``) mark the window
(``bench.window``) and its calls into the program (``bench.step``,
``bench.call``, ``bench.edit``, ``bench.sync``); the device ops are the
trace's kernels, copies and sets.  Times are in microseconds, as the trace has them."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

from .stats import idle_gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class TraceView:
    """The window of a traced run.  ``device``: ``(name, start, end)`` of
    every device op that ran in the window; ``host``: ``(name, start, end,
    cat)`` of the host's ops and spans; ``window``: ``(start, end)``;
    ``units``: the frames or steps the window completed."""

    def __init__(self, events, units: int):
        region = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == "bench.window"]
        if len(region) != 1:
            raise RuntimeError(f"{len(region)} 'bench.window' spans traced")
        w0 = float(region[0]["ts"])
        w1 = w0 + float(region[0]["dur"])
        self.window = (w0, w1)
        self.device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS
                       and w0 <= float(e["ts"]) < w1]
        self.host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["cat"]) for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS
                     and w0 <= float(e["ts"]) < w1]
        self.units = units
        if not self.device:
            raise RuntimeError("no device op ran in the traced window")

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for _, a, b in self.device]) * 1e-6

    def device_ms(self, match) -> float:
        """Device ms per unit of the ops whose name ``match(name)`` takes."""
        us = sum(b - a for n, a, b in self.device if match(n))
        return us * 1e-3 / self.units

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def host_ms(self, span: str) -> float:
        """Mean host ms of the benchmark's span ``span``."""
        d = [b - a for n, a, b, c in self.host
             if c == "user_annotation" and n == span]
        return sum(d) * 1e-3 / len(d) if d else None

    def breakdown(self) -> dict:
        """The device ops with the most time, and the longest idle gaps,
        each named by the innermost host op or span running at its middle."""
        by_name = defaultdict(float)
        for n, a, b in self.device:
            by_name[n] += (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = idle_gaps([(a, b) for _, a, b in self.device], *self.window)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        host = sorted(self.host, key=lambda h: h[1])
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [h for h in host if h[1] <= mid < h[2]]
            name = (max(inner, key=lambda h: h[1])[0] if inner else "host: none")
            named.append([name, (b - a) * 1e-6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def traced(fn, units_of):
    """Run ``fn()`` under the profiler; returns ``(fn's result,
    TraceView)`` with ``units_of(result)`` the units the window completed.
    The trace goes through a file under ``TMPDIR``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, TraceView(events, units_of(out))
