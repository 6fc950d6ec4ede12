"""Fused per-client clip-factor + SGD + aggregation-select update.

Port of `repro.kernels.clip_sgd` (TPU kernels ``_kernel`` and
``_kernel_ext``, both called from ``clip_sgd_update``).  Per ``[N, D]``
parameter leaf of the HASFL round (`core.split.hasfl_round_update`):
scale the raw gradient by the per-client clip factor, one SGD step (Eq.
5-6), the survivor-weighted Eq. 4/7 client mean, and the membership/
aggregation select —

    spec   = p - gamma * g * scale
    common = sum(w * spec) / where(cnt > 0, cnt, 1),  cnt = sum(w)
    out    = keep ? spec : (not any(keep) and cnt > 0 ? common : p)

— or, in mesh mode, the external-mean form, whose mean ``common`` ([D])
arrives precomputed by the two-tier combine (`core.split.two_tier_common`,
whose all-reduces a kernel cannot issue):

    out    = keep ? spec : (use_common ? common : p)

On the card both are ``csrc/clip_sgd.cu`` (CUDA C++ for sm_90a), which
updates every leaf of a round in one launch and in place (the analogue of
the reference's donated leaf).  `clip_sgd_leaves_kernel` is the round's
call: a list of leaves, one per-leaf ``keep_spec`` flag, and the round's
shared columns (clip factors, participation weights), from which the
kernel builds each leaf's keep vector (``keep_spec and w > 0``).
The grid runner folds G cells of N clients into ``[G·N, D]`` leaves
(``cells=G``): a table entry is then one (cell, leaf) pair, pointing at the
cell's N rows of the leaf and of the shared columns, with the cell's own
``keep_spec``, so one launch a `CAPACITY` entries updates every cell and
each cell's mean sums its own rows as a one-cell launch does.
`clip_sgd_kernel` and `clip_sgd_ext_kernel` are the one-leaf case of the
same launch with the caller's own ``[N]`` keep vector, as the reference's
kernels take it.  A launch takes up to `CAPACITY` leaves; the wrapper
packs them into a `ctypes` table (pointers, sizes, per-leaf flags and
first chunks under `clip_sgd_plan`), and launches on the current raw
stream (`launch`).

A leaf is fp32 or bf16 (the token models' units mix bf16 weights and
fp32 norm scales in one round): a bf16 leaf's math is fp32 and its
result is rounded once on the store, as the TPU kernel's
``.astype(o_ref.dtype)``; p and g of a leaf share its type.  In the
external form a bf16 leaf's mean arrives in bf16 (the two-tier combine
runs in the leaf's type) and the wrapper widens it to fp32 once, which is
exact, as ``_kernel_ext`` casts ``c_ref`` to fp32.

What bounds it on the card: memory, 3·itemsize·N·ΣD bytes (p and g
read, p written), plus 4·ΣD for the external mean rows; rows whose
result does not depend on p and g are not read (see the source's note).

`clip_sgd_plain` and `clip_sgd_ext_plain` are the plain PyTorch versions
(the reference's ``clip_sgd_ref`` algebra), and `clip_sgd_leaves_plain`
their loop over a round's leaves (and cells), for CPU tensors and tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream
from repro_torch.utils.cells import fold, rows

THREADS = 256    # a block (csrc/clip_sgd.cu)
CAPACITY = 64    # (cell, leaf) entries a launch; resnet18-cifar, the
                 # port's largest CNN by leaves, has 42
MAX_N = 4096     # clients: three fp32 columns in a block's shared memory
LEAF_TYPES = (torch.float32, torch.bfloat16)
ROWS = 4         # rows a thread streams at once (1, 2, 4, 8)
VECTORS = 1      # column vectors a thread owns in a chunk (1, 2)


def clip_sgd_plain(p, g, scale, keep_spec, participation=None, *,
                   gamma: float):
    """``p, g: [N, D]``; ``scale``: [N]; ``keep_spec``: per-client keep
    vector [N]; ``participation``: [N] survivor weights or None (full
    cohort: the plain client mean).  Returns the updated leaf (new
    tensor); the same op sequence as the reference's ``clip_sgd_ref``."""
    g = g * scale.reshape(-1, 1)
    spec = p - gamma * g.to(p.dtype)
    keep = keep_spec.reshape(-1, 1).to(torch.bool)
    if participation is None:
        common = spec.mean(dim=0)
        return torch.where(keep, spec, common[None].expand_as(p))
    w = participation.to(spec.dtype).reshape(-1, 1)
    cnt = participation.to(spec.dtype).sum()
    # where, not maximum: fractional weights may sum below 1
    common = (spec * w).sum(dim=0) / torch.where(cnt > 0, cnt, 1.0)
    use_common = torch.logical_and(torch.logical_not(keep.any()), cnt > 0)
    fallback = torch.where(use_common, common[None].expand_as(p), p)
    return torch.where(keep, spec, fallback)


def clip_sgd_ext_plain(p, g, scale, keep, common, use_common, *,
                       gamma: float):
    """``p, g: [N, D]``; ``scale``, ``keep``: [N]; ``common``: the [D]
    precomputed Eq. 4/7 mean (participation already folded in);
    ``use_common``: the global scalar flag.  Returns the updated leaf (a
    new tensor); the reference's ``clip_sgd_ref(..., common=)`` algebra."""
    g = g * scale.reshape(-1, 1)
    spec = p - gamma * g.to(p.dtype)
    keep = keep.reshape(-1, 1).to(torch.bool)
    use = torch.as_tensor(use_common, device=p.device).to(torch.bool)
    fallback = torch.where(use, common.reshape(1, -1).to(p.dtype)
                           .expand_as(p), p)
    return torch.where(keep, spec, fallback)


def _keep_vector(keep_spec: bool, participation, n: int, device):
    """A leaf's keep vector: ``keep_spec`` for every client, or only for
    the survivors (``participation > 0``)."""
    if participation is None:
        return torch.full((n,), keep_spec, device=device)
    return (participation > 0) & keep_spec


def clip_sgd_leaves_plain(ps, gs, scale, keep_specs, participation=None, *,
                          gamma: float, commons=None, count=None, cells=1):
    """A round's leaves through the per-leaf plain versions.  ``ps, gs``:
    lists of ``[N, D_i]``; ``keep_specs``: one bool a leaf; the keep vector
    of leaf i is ``keep_specs[i]`` for the survivors.  With ``commons`` (the
    ``[D_i]`` means of mesh mode) the external-mean form runs, leaf i taking
    its mean where ``count > 0 and not keep_specs[i]`` (``count``: the
    global survivor count).  ``cells=G`` folds G cells of N clients: the
    leaves are ``[G·N, D_i]``, ``scale`` and ``participation`` ``[G·N]``,
    ``keep_specs`` one such list a cell, and each cell is updated as by its
    own call.  Returns new tensors."""
    if cells > 1:
        if commons is not None:
            raise ValueError("the external mean takes one cell")
        n = _cell_size(ps[0].shape[0], cells, keep_specs)
        return fold([clip_sgd_leaves_plain(
            rows(ps, g, n), rows(gs, g, n), rows(scale, g, n),
            keep_specs[g], rows(participation, g, n), gamma=gamma)
            for g in range(cells)])
    n = ps[0].shape[0]
    out = []
    for i, (p, g) in enumerate(zip(ps, gs)):
        keep = _keep_vector(keep_specs[i], participation, n, p.device)
        if commons is None:
            out.append(clip_sgd_plain(p, g, scale, keep, participation,
                                      gamma=gamma))
        else:
            use = (count > 0) & (not keep_specs[i])
            out.append(clip_sgd_ext_plain(p, g, scale, keep, commons[i], use,
                                          gamma=gamma))
    return out


def _cell_size(n_rows: int, cells: int, keep_specs) -> int:
    if cells < 1 or n_rows % cells or len(keep_specs) != cells:
        raise ValueError(f"{n_rows} rows do not fold {cells} cells with one "
                         f"keep_spec list a cell ({len(keep_specs)})")
    return n_rows // cells


def clip_sgd_plan(ds, aligned, vectors: int = VECTORS):
    """(first chunks, vector flags, chunk count) of a launch over entries
    of ``ds`` columns (a leaf, or one cell's rows of a leaf): entry i takes
    16-byte vectors where ``aligned[i]`` (its pointers are 16-byte aligned)
    and ``ds[i] % 4 == 0``, single elements otherwise, and is cut into
    chunks of ``THREADS · vectors`` vectors, one block each, entry after
    entry."""
    starts, vecs, total = [], [], 0
    for d, al in zip(ds, aligned):
        vec = bool(al) and d % 4 == 0
        starts.append(total)
        vecs.append(vec)
        total += -(-d // (THREADS * vectors * (4 if vec else 1)))
    return starts, vecs, total


def cell_entries(leaves, keep_specs, n: int, sizes):
    """The table entries ``(p, g, c, d, keep_spec, row)`` of a launch, cell
    after cell: ``leaves`` holds ``(i, p, g, c, d)`` of each non-empty
    leaf (``[G·n, d]`` at addresses p and g; c its external mean's or 0),
    ``sizes`` their bytes an element (4 for fp32, 2 for bf16),
    ``keep_specs[cell][i]`` the keep flag of leaf i in a cell.  Cell
    ``g``'s entry of a leaf points at its rows ``[g·n, (g+1)·n)``."""
    return [(pp + size * cell * n * d, gp + size * cell * n * d, cp, d,
             bool(keep_specs[cell][i]), cell * n)
            for cell in range(len(keep_specs))
            for (i, pp, gp, cp, d), size in zip(leaves, sizes)]


def plan_code(rows: int = ROWS, vectors: int = VECTORS) -> int:
    """R and V packed into the one int `repro_clip_sgd` takes."""
    return rows | vectors << 4


class Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("d", ctypes.c_int64),
                ("start", ctypes.c_int32), ("flags", ctypes.c_int32),
                ("row", ctypes.c_int32)]


class Table(ctypes.Structure):
    """``csrc/clip_sgd.cu``'s ``Table``, field for field."""
    _fields_ = [("leaf", Leaf * CAPACITY), ("scale", ctypes.c_void_p),
                ("w", ctypes.c_void_p), ("keep", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("gamma", ctypes.c_float),
                ("n", ctypes.c_int32), ("leaves", ctypes.c_int32),
                ("chunks", ctypes.c_int32), ("u_is_count", ctypes.c_int32)]


@functools.lru_cache(maxsize=1)
def symbol():
    lib = build.load("clip_sgd")
    size = lib.repro_clip_sgd_table_bytes()
    if size != ctypes.sizeof(Table):
        raise RuntimeError(f"csrc/clip_sgd.cu's table is {size} bytes, the "
                           f"wrapper's {ctypes.sizeof(Table)}")
    fn = lib.repro_clip_sgd
    fn.argtypes = [ctypes.POINTER(Table), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _column(t, n: int, index: int, what: str):
    """``t`` as a contiguous fp32 ``[n]`` column on card ``index`` (no copy
    where it is one already)."""
    if not (t.is_cuda and t.get_device() == index
            and t.dtype is torch.float32 and t.is_contiguous()):
        t = t.to(device=torch.device("cuda", index), dtype=torch.float32)
    t = t.reshape(-1)
    if t.numel() != n:
        raise ValueError(f"{what} has {t.numel()} values for N={n} clients")
    return t.contiguous()


def tables(ps, gs, scale, keep_specs, participation=None, *, gamma: float,
           commons=None, keep=None, use=None, use_is_count=False,
           vectors: int = VECTORS, cells: int = 1):
    """The launches' tables for the leaves ``ps, gs`` (CUDA fp32 or bf16,
    checked), `CAPACITY` entries a table, and the tensors they point into
    (to be kept alive until the launches are issued; a bf16 mean widened
    to fp32 among them).  ``keep`` ([N], optional)
    replaces the per-leaf keep vectors; ``use`` is the external mean's
    one-element flag or, with ``use_is_count``, the global survivor
    count.  ``cells=G``: the leaves and columns fold G cells of N rows
    (`clip_sgd_leaves_plain`), one entry a (cell, leaf), cell after
    cell."""
    if cells > 1 and (commons is not None or keep is not None):
        raise ValueError("the external mean and a caller's keep vector "
                         "take one cell")
    if cells == 1:
        keep_specs = [keep_specs]
    elif ps:
        _cell_size(ps[0].shape[0], cells, keep_specs)
    if len(gs) != len(ps) or any(len(k) != len(ps) for k in keep_specs) \
            or (commons is not None and len(commons) != len(ps)):
        raise ValueError("one g, keep_spec (and common) a leaf")
    if not ps:
        return [], []
    p0 = ps[0]
    if not p0.is_cuda:
        raise ValueError(f"clip_sgd takes CUDA tensors, got {p0.device}")
    index, rows_all = p0.get_device(), p0.shape[0]
    n = rows_all // cells
    if not 1 <= n <= MAX_N:
        raise ValueError(f"clip_sgd takes 1 to {MAX_N} clients, got {n}")
    cols = [_column(scale, rows_all, index, "scale")]
    if participation is not None:
        cols.append(_column(participation, rows_all, index,
                            "participation"))
    if keep is not None:
        cols.append(_column(keep, n, index, "keep"))
    if commons is not None:
        cols.append(_column(use, 1, index, "use_common"))
    f32 = torch.float32
    leaves, sizes, widened = [], [], []
    for i, (p, g) in enumerate(zip(ps, gs)):
        shape = p.shape   # get_device() is -1 on the CPU
        if (p.get_device() != index or g.get_device() != index
                or p.dtype not in LEAF_TYPES or g.dtype is not p.dtype
                or len(shape) != 2 or shape[0] != rows_all
                or g.shape != shape
                or not (p.is_contiguous() and g.is_contiguous())):
            raise ValueError(
                f"clip_sgd takes contiguous [N={rows_all}, D] p and g of one "
                f"shape and type (fp32 or bf16) "
                f"on cuda:{index}; leaf {i}: {p.dtype} "
                f"{tuple(shape)} on {p.device}, {g.dtype} {tuple(g.shape)} "
                f"on {g.device}")
        d = shape[1]
        if d == 0:
            continue
        cp = 0
        if commons is not None:
            c = commons[i]
            if not (c.get_device() == index and c.dtype in (f32, p.dtype)
                    and c.numel() == d):
                raise ValueError(f"common of leaf {i} must be [{d}] in fp32 "
                                 f"or the leaf's type on cuda:{index}")
            if c.dtype is not f32 or not c.is_contiguous():
                c = c.to(f32).contiguous()
                widened.append(c)
            cp = c.data_ptr()
        leaves.append((i, p.data_ptr(), g.data_ptr(), cp, d))
        sizes.append(p.element_size())
    entries = cell_entries(leaves, keep_specs, n, sizes)
    bf16 = [size == 2 for _ in keep_specs for size in sizes]
    aligned = [not (pp | gp | cp) & 15 for pp, gp, cp, *_ in entries]
    out = []
    ptr = [c.data_ptr() for c in cols]
    w = ptr[1] if participation is not None else None
    k = ptr[1 + (participation is not None)] if keep is not None else None
    u = ptr[-1] if commons is not None else None
    for lo in range(0, len(entries), CAPACITY):
        part = entries[lo:lo + CAPACITY]
        starts, vecs, chunks = clip_sgd_plan(
            [e[3] for e in part], aligned[lo:lo + CAPACITY], vectors)
        table = (Leaf * CAPACITY)(*[
            (pp, gp, cp or None, d, s, ks | v << 1 | bf << 2, row)
            for (pp, gp, cp, d, ks, row), s, v, bf
            in zip(part, starts, vecs, bf16[lo:lo + CAPACITY])])
        out.append(Table(table, ptr[0], w, k, u, gamma, n, len(part),
                         chunks, use_is_count))
    return out, cols + widened


def _launch(kernel, index: int, tabs, code: int) -> None:
    fn = symbol()
    with device_scope(index):
        stream = raw_stream(index)
        for tab in tabs:
            err = fn(ctypes.byref(tab), code, stream)
            if err != 0:
                raise RuntimeError(
                    f"clip_sgd kernel launch failed: CUDA error {err} "
                    f"({tab.leaves} leaves, N={tab.n}, plan {code:#x})")
            kernel.launches += 1


def clip_sgd_leaves_kernel(ps, gs, scale, keep_specs, participation=None, *,
                           gamma: float, commons=None, count=None,
                           cells=1):
    """A round's update on the card, in one launch a `CAPACITY` entries
    (leaves, or (cell, leaf) pairs with ``cells``): updates the contiguous
    fp32 or bf16 CUDA leaves ``ps`` (``[N, D_i]``, or ``[G·N, D_i]``) in place and
    returns them.  The arguments are `clip_sgd_leaves_plain`'s; ``count``
    (with ``commons``) stays on the device (no host sync).  Launches count
    on `clip_sgd_kernel` (flat) or `clip_sgd_ext_kernel` (external
    mean)."""
    if commons is not None and count is None:
        raise ValueError("the external mean needs the global count")
    tabs, _cols = tables(ps, gs, scale, keep_specs, participation,
                         gamma=gamma, commons=commons, use=count,
                         use_is_count=True, cells=cells)
    if tabs:
        kernel = clip_sgd_kernel if commons is None else clip_sgd_ext_kernel
        _launch(kernel, ps[0].get_device(), tabs, plan_code())
    return list(ps)


def clip_sgd_kernel(p, g, scale, keep_spec, participation=None, *,
                    gamma: float):
    """The flat update of one contiguous fp32 CUDA leaf ``p`` ``[N, D]``,
    in place; returns it.  ``keep_spec`` is the per-client keep vector
    [N]; ``participation=None`` runs with all-ones weights."""
    tabs, _cols = tables([p], [g], scale, [False], participation,
                         gamma=gamma, keep=keep_spec)
    if tabs:
        _launch(clip_sgd_kernel, p.get_device(), tabs, plan_code())
    return p


clip_sgd_kernel.launches = 0


def clip_sgd_ext_kernel(p, g, scale, keep, common, use_common, *,
                        gamma: float):
    """The external-mean update of one contiguous fp32 or bf16 CUDA leaf
    ``p`` ``[N, D]``, in place; returns it.  ``common`` holds D values,
    ``use_common`` is a bool or a one-element tensor (kept on the device:
    no host sync)."""
    if not p.is_cuda:
        raise ValueError(f"clip_sgd takes CUDA tensors, got {p.device}")
    if common.numel() != p.shape[-1]:
        raise ValueError(f"common has {common.numel()} values, the leaf "
                         f"has D={p.shape[-1]}")
    dev = p.device
    common = common.to(device=dev, dtype=torch.float32).reshape(-1) \
        .contiguous()
    u = torch.as_tensor(use_common, device=dev)
    tabs, _cols = tables([p], [g], scale, [False], gamma=gamma,
                         commons=[common], keep=keep, use=u)
    if tabs:
        _launch(clip_sgd_ext_kernel, p.get_device(), tabs, plan_code())
    return p


clip_sgd_ext_kernel.launches = 0
