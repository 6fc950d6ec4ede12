"""Per-unit moments of the gradient samples behind the HASFL controller's
online G²/σ² estimate, on the card.

No TPU kernel: the reference takes these moments in numpy on the host
(`core.convergence.estimate_constants`, over fp64 copies of every gradient
sample), and the port's CPU path still does
(`scenarios.controller.estimate_profile_constants`).  For K samples (the
controller draws K = 3 batches) of a model cut into units, per unit u over
every element i of the unit's leaves, in fp64:

    g_sq[u]     = mean_k sum_i x_k[i]²
    sigma_sq[u] = mean_k sum_i (x_k[i] − m[i])²,   m = ((x_0 + x_1) + x_2) / K

the sums over k left to right, as numpy's `stack.mean(axis=0)` and
`np.mean` take them.

On the card this is ``csrc/grad_moments.cu``: two launches whatever the
model.  A block per chunk of `CHUNK` elements of one leaf writes its 2K
fp64 sums, then a block per unit adds its chunks' sums in chunk order.
No atomics, so a result repeats bitwise.  `grad_moments_kernel` is the
call: it packs one table entry per (unit, leaf) — the K samples'
pointers, the element count, the leaf's first chunk under
`grad_moments_plan`, its flags — into pinned memory, copies it to the card
ahead of the launches, and returns the ``[U, 2]`` fp64 moments on the card
(no host sync).  A leaf is fp32 or bf16 (a token model's units mix bf16
weights and fp32 norm scales).

`grad_moments_plain` is the kernel's arithmetic in its order, in fp64
numpy on the host: each element's sums, products, difference and
division rounded as the kernel rounds them, a thread's elements in its
order, each warp's shuffle tree, the warps, the chunks.  The card's tests
hold the kernel to it bitwise, and the tests hold it to
`estimate_constants` within 1e-12 relative (the same fp64 sums taken in
another order).

What bounds it on the card: memory, K·itemsize·Σn bytes read once
(VGG-16 at K = 3: 183 MB, 0.055 ms at 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream
from repro_torch.utils.tree import tree_leaves

THREADS = 256     # a block of the chunks' launch (csrc/grad_moments.cu)
CHUNK = 8192      # elements a block
MAX_SAMPLES = 4   # K
WARPS = THREADS // 32
ENTRY_WORDS = MAX_SAMPLES + 3   # int64 words of a table entry
LEAF_TYPES = (torch.float32, torch.bfloat16)
LAUNCHES = 2      # a call: the chunks' sums, then the units'
SLAB = 256        # chunks `grad_moments_plain` takes at once (~300 MB at K = 3)


def vector_width(itemsize: int) -> int:
    """Elements of a 16-byte vector: 4 fp32 or 8 bf16."""
    return 16 // itemsize


def vectorized(ptrs, n: int, itemsize: int) -> bool:
    """Whether a leaf of ``n`` elements at the K addresses ``ptrs`` takes
    16-byte vectors: every address 16-byte aligned and ``n`` a multiple of
    the vector."""
    return all(p % 16 == 0 for p in ptrs) and n % vector_width(itemsize) == 0


def grad_moments_plan(sizes):
    """(first chunk of each leaf, unit after unit; first chunk of each unit
    and, last, the chunk count) for units whose leaves hold ``sizes[u]``
    elements: a leaf of n elements takes ceil(n / `CHUNK`) chunks, one
    block each, leaf after leaf, so each unit's chunks are consecutive."""
    starts, bounds, total = [], [], 0
    for unit in sizes:
        bounds.append(total)
        for n in unit:
            starts.append(total)
            total += -(-n // CHUNK)
    bounds.append(total)
    return starts, bounds


def unit_leaves(samples):
    """Per unit, the K-tuples of one leaf's tensors in the K ``samples``
    (each a list over units of gradient trees, as `SFLEdgeSimulator._grad_fn`
    returns them); raises unless every sample has the same units and
    leaves."""
    k = len(samples)
    if not 1 <= k <= MAX_SAMPLES:
        raise ValueError(f"grad_moments takes 1 to {MAX_SAMPLES} samples, "
                         f"got {k}")
    n_units = len(samples[0])
    if any(len(s) != n_units for s in samples):
        raise ValueError("every sample holds the same units")
    out = []
    for u in range(n_units):
        per = [tree_leaves(s[u]) for s in samples]
        if any(len(p) != len(per[0]) for p in per):
            raise ValueError(f"unit {u} has another number of leaves in "
                             f"another sample")
        out.append(list(zip(*per)))
    return out


def table(units):
    """The launch's table for ``units`` (`unit_leaves`'s K-tuples), as
    int64 words: one entry of `ENTRY_WORDS` per non-empty leaf (the K
    addresses, unused ones 0; the element count; the first chunk; the
    flags, bit 0 for 16-byte vectors and bit 1 for bf16), then the first
    chunk of each unit and the chunk count.  Returns (words, entries,
    chunks).  Raises on a leaf the kernel does not take."""
    sizes, rows = [], []
    for u, unit in enumerate(units):
        ns = []
        for i, xs in enumerate(unit):
            x0 = xs[0]
            if (x0.dtype not in LEAF_TYPES
                    or any(x.dtype is not x0.dtype or x.device != x0.device
                           or x.numel() != x0.numel()
                           or not x.is_contiguous() for x in xs)):
                raise ValueError(
                    f"grad_moments takes contiguous fp32 or bf16 leaves of "
                    f"one type, size and device in every sample; unit {u} "
                    f"leaf {i}: " + ", ".join(
                        f"{x.dtype} {tuple(x.shape)} on {x.device}"
                        for x in xs))
            if x0.numel() == 0:
                continue
            ns.append(x0.numel())
            rows.append(xs)
        sizes.append(ns)
    starts, bounds = grad_moments_plan(sizes)
    words = np.zeros(len(rows) * ENTRY_WORDS + len(bounds), np.int64)
    for e, (xs, start) in enumerate(zip(rows, starts)):
        ptrs = [x.data_ptr() for x in xs]
        n, size = xs[0].numel(), xs[0].element_size()
        row = words[e * ENTRY_WORDS:(e + 1) * ENTRY_WORDS]
        row[:len(ptrs)] = ptrs
        row[MAX_SAMPLES:] = (n, start,
                             vectorized(ptrs, n, size) | (size == 2) << 1)
    words[len(rows) * ENTRY_WORDS:] = bounds
    return words, len(rows), bounds[-1]


@functools.lru_cache(maxsize=1)
def symbol():
    lib = build.load("grad_moments")
    size = lib.repro_grad_moments_entry_bytes()
    if size != 8 * ENTRY_WORDS:
        raise RuntimeError(f"csrc/grad_moments.cu's entry is {size} bytes, "
                           f"the wrapper's {8 * ENTRY_WORDS}")
    fn = lib.repro_grad_moments
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grad_moments_kernel(samples):
    """The ``[U, 2]`` fp64 moments ``(g_sq, sigma_sq)`` of each unit of the
    K gradient ``samples`` (lists over units of trees of CUDA fp32 or bf16
    leaves, checked), on their card: two launches on the current stream,
    no host sync.  A unit with no elements reads 0."""
    units = unit_leaves(samples)
    k = len(samples)
    leaves = [xs[0] for unit in units for xs in unit]
    if not leaves or not leaves[0].is_cuda:
        where = leaves[0].device if leaves else "no leaf"
        raise ValueError(f"grad_moments takes CUDA tensors, got {where}")
    dev = leaves[0].device
    if any(x.device != dev for x in leaves):
        raise ValueError("grad_moments takes every leaf on one card")
    words, entries, chunks = table(units)
    if chunks == 0:
        return torch.zeros((len(units), 2), dtype=torch.float64, device=dev)
    host = torch.from_numpy(words).pin_memory()
    tab = host.to(dev, non_blocking=True)
    partials = torch.empty(chunks * 2 * k, dtype=torch.float64, device=dev)
    out = torch.empty((len(units), 2), dtype=torch.float64, device=dev)
    index = dev.index
    with device_scope(index):
        err = symbol()(tab.data_ptr(), entries,
                       tab.data_ptr() + 8 * entries * ENTRY_WORDS,
                       len(units), chunks, k, partials.data_ptr(),
                       out.data_ptr(), raw_stream(index))
    if err != 0:
        raise RuntimeError(f"grad_moments kernel launch failed: CUDA error "
                           f"{err} ({entries} leaves, {len(units)} units, "
                           f"{chunks} chunks, K={k})")
    grad_moments_kernel.launches += LAUNCHES
    return out


grad_moments_kernel.launches = 0


def _chunk_sums(xs, width: int, c0: int, c1: int) -> np.ndarray:
    """``[C, 2K]``: the sums of chunks ``c0`` to ``c1`` of one leaf (the K
    tensors ``xs``) as the kernel's blocks take them, ``width`` elements a
    thread's step (a vector, or 1)."""
    k = len(xs)
    lo, hi = c0 * CHUNK, min(c1 * CHUNK, xs[0].numel())
    x = np.zeros((k, (c1 - c0) * CHUNK))
    for j, t in enumerate(xs):
        x[j, :hi - lo] = t.detach().reshape(-1)[lo:hi].double().cpu().numpy()
    m = x[0]
    for j in range(1, k):
        m = m + x[j]
    m = m / k
    d = x - m
    terms = np.concatenate([x * x, d * d])                  # [2K, elements]
    steps = CHUNK // (THREADS * width)
    terms = terms.reshape(2 * k, c1 - c0, steps, THREADS, width)
    acc = np.zeros((2 * k, c1 - c0, THREADS))
    for s in range(steps):
        for e in range(width):
            acc = acc + terms[:, :, s, :, e]
    lanes = acc.reshape(2 * k, c1 - c0, WARPS, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = np.concatenate([lanes[..., :off] + lanes[..., off:2 * off],
                                lanes[..., off:]], axis=-1)
    total = lanes[..., 0, 0]
    for w in range(1, WARPS):
        total = total + lanes[..., w, 0]
    return total.T


def grad_moments_plain(samples) -> np.ndarray:
    """`grad_moments_kernel`'s ``[U, 2]`` fp64 result by the kernel's
    arithmetic in its order, in numpy on the host (leaves on any device),
    `SLAB` chunks of a leaf at a time."""
    units = unit_leaves(samples)
    k = len(samples)
    out = np.zeros((len(units), 2))
    for u, unit in enumerate(units):
        sums = np.zeros(2 * k)
        for xs in unit:
            n, size = xs[0].numel(), xs[0].element_size()
            ptrs = [x.data_ptr() for x in xs]
            width = vector_width(size) if vectorized(ptrs, n, size) else 1
            chunks = -(-n // CHUNK)
            for c0 in range(0, chunks, SLAB):
                for part in _chunk_sums(xs, width, c0,
                                        min(c0 + SLAB, chunks)):
                    sums = sums + part
        g, v = sums[0], sums[k]
        for j in range(1, k):
            g, v = g + sums[j], v + sums[k + j]
        out[u] = g / k, v / k
    return out
