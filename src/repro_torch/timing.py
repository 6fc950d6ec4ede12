"""Device time of work replayed from a CUDA graph (host launch time out).

Shared by `chip_smoke.py`, `repro_torch.flash_ablation` and
`repro_torch.rmsnorm_ablation`.  Needs a card.
"""
from __future__ import annotations

import torch


def graph_ms(fn, calls: int = 1, reps: int = 5) -> float:
    """Device milliseconds of ``calls`` calls of ``fn`` captured in one
    CUDA graph, the mean over ``reps`` replays after a warm-up replay.

    ``fn`` runs twice on a side stream first (allocations and lazy set-up
    stay out of the capture).  Kernels launched on the current raw stream
    are captured, since during capture that is the capture stream."""
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
