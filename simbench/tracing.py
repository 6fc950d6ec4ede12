"""The reduction of one traced window to what the per-layer metrics read.

`Trace.from_profiler` takes the events of a `torch.profiler` run with CPU
and CUDA activities: the harness's own ranges on the host (``policy``,
``segment``, ``eval``, from `record_function`) and every operation on the
device (kernels, copies, sets).  Each device operation is attributed to
the host range in force when the host op that launched it started (the
profiler's correlation of launch and operation), or, where no launch is
recorded, when it started on the device.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

RANGES = ("policy", "segment", "eval")


def kernel_id(name: str) -> str:
    """A device operation's function name without namespaces, template
    arguments or parameters (``void (anonymous namespace)::tcb::
    dq_kernel<64>(...)`` -> ``dq_kernel``)."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.split("::")[-1]


def busy_union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


class Trace:
    """Device operations ``(name, start_ns, end_ns, range)`` and host
    ranges ``(name, start_ns, end_ns)`` of one traced window."""

    def __init__(self, device_ops: list, ranges: list):
        self.ops = device_ops
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self._starts = [r[1] for r in self.ranges]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        ranges, launch_at, device = [], {}, []
        for ev in events:
            if ev.device_type() == DeviceType.CPU:
                start = _ns(ev, "start")
                if ev.name() in RANGES:
                    ranges.append((ev.name(), start,
                                   start + int(ev.duration_ns())))
                launch_at[ev.correlation_id()] = start
            elif ev.device_type() == DeviceType.CUDA \
                    and ev.name() not in RANGES:
                start = _ns(ev, "start")
                device.append((ev.name(), start,
                               start + int(ev.duration_ns()),
                               launch_at.get(ev.linked_correlation_id())))
        out = cls([], ranges)
        out.ops = [(name, s, e, out.range_at(s if at is None else at))
                   for name, s, e, at in device]
        return out

    def range_at(self, t_ns: int) -> str:
        """The host range in force at ``t_ns`` (``"other"`` outside all)."""
        i = bisect.bisect_right(self._starts, t_ns) - 1
        if i >= 0 and self.ranges[i][1] <= t_ns < self.ranges[i][2]:
            return self.ranges[i][0]
        return "other"

    def busy_s(self) -> float:
        return busy_union((s, e) for _, s, e, _ in self.ops) / 1e9

    def seconds(self, kernels=None, within=None) -> float:
        """Summed device seconds of the operations whose `kernel_id` is in
        ``kernels`` (None: all), launched within host range ``within``
        (None: any)."""
        return sum(e - s for name, s, e, r in self.ops
                   if (kernels is None or kernel_id(name) in kernels)
                   and (within is None or r == within)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for name, s, e, _ in self.ops:
            by[kernel_id(name) or name[:64]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest device idle gaps, each named by the host range
        in force where it began."""
        gaps, end = [], None
        for s, e in sorted((s, e) for _, s, e, _ in self.ops):
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        return [[self.range_at(at), g / 1e9] for g, at in gaps[:k]]
