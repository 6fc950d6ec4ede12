"""Device time of work replayed from a CUDA graph (host launch time out).

Shared by `chip_smoke.py`, `repro_torch.flash_ablation`,
`repro_torch.rmsnorm_ablation` and `repro_torch.mlstm_ablation`.  Needs a
card.
"""
from __future__ import annotations

import torch


def _captured(fn, calls: int):
    """``calls`` calls of ``fn`` captured in one CUDA graph, after two
    calls on a side stream (allocations and lazy set-up stay out of the
    capture) and one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, calls: int = 1, reps: int = 5) -> float:
    """Device milliseconds of ``calls`` calls of ``fn`` captured in one
    CUDA graph, the mean over ``reps`` replays after a warm-up replay.

    ``fn`` runs twice on a side stream first (allocations and lazy set-up
    stay out of the capture).  Kernels launched on the current raw stream
    are captured, since during capture that is the capture stream."""
    graph = _captured(fn, calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def launch_split(fn, reps: int = 20) -> dict:
    """The kernels one call of ``fn`` launches, by name: ``{name: {"launches":
    n, "ms": device ms}}`` per call, read by `torch.profiler` (CUPTI's
    kernel records, device clock) over ``reps`` replays of one call
    captured in a CUDA graph, so host launch time is out of the numbers.
    Raises if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    graph = _captured(fn, 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    split: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.name.startswith(("Memcpy", "Memset")):
            continue
        row = split.setdefault(ev.name, {"launches": 0, "ms": 0.0})
        row["launches"] += 1
        row["ms"] += (ev.time_range.end - ev.time_range.start) / 1e3
    if not split:
        raise RuntimeError("the profiler saw no kernel on the card")
    return {name: {"launches": row["launches"] / reps, "ms": row["ms"] / reps}
            for name, row in split.items()}
