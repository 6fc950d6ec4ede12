"""Flash attention (forward) with GQA, causal / sliding-window and pad masks.

Port of `repro.kernels.flash_attention` (TPU kernel ``_kernel`` /
``flash_attention``).  Shapes: q ``[B, Sq, Hq, hd]``; k, v
``[B, Sk, Hkv, hd]`` with ``Hq % Hkv == 0``; out ``[B, Sq, Hq, hd]`` in q's
type.  Query row ``i`` sits at position ``i`` and key ``j`` at ``j``; a key
counts when ``j < sk_valid`` (default ``Sk``), ``j <= i`` if causal, and
``j > i - window`` if ``window``.  Scores, the online softmax and the PV
sum accumulate in fp32 (the bf16 prefill rounds P to bf16 for the PV
product, below), and the output is ``acc / max(l, 1e-30)``, as on the
TPU.

`flash_attention_kernel` is ``csrc/flash_attention.cu`` (CUDA C++ for
sm_90a).  On the TPU the KV tiles were the sequential third grid axis,
with (m, l, acc) in VMEM scratch across it; on the card blocks run in no
order, so each block owns one (batch, kv head, tile of GQA-folded query
rows) and loops over the KV tiles itself.  GQA folds the ``Hq / Hkv``
query heads of one kv head into the block's rows (row = position · group
+ head-in-group), so each K/V tile is loaded once for the whole group and
no K/V is copied per head.  KV tiles wholly above the causal diagonal,
wholly below the window, or at or past ``sk_valid`` are skipped.  The
wrapper picks one of three kernels by the inputs, and counts each path:

- bf16 with ``Sq > 1`` (prefill) — the tensor-core kernel
  (``launches_tc``): 128 folded rows a block in two warpgroups, K/V tiles
  of 64 keys through a cp.async ring, ``S = QKᵀ`` and ``O += PV`` as
  ``wgmma`` with fp32 accumulators, the online softmax on the accumulator
  fragments.  P is rounded to bf16 for the PV product (about 2⁻⁹
  relative, the one departure from the TPU kernel, which kept P fp32;
  inside the bf16 bar 2e-2).  hd 32 and 96 sit zero-padded to 64 and
  128 dims in shared memory.  Bound: bytes at qwen3's prefill shape,
  operations (989 TFLOP/s) at longer ones.
- decode, fp32 or bf16 — split-KV (``launches_split_kv``,
  `flash_decode_kernel`): one query token against a cache whose slots
  carry the position they hold, ``k_pos [B, C]`` (int32, -1 = empty), with
  the query at ``cur_pos [B]`` and an optional window, all read by the
  kernel from device memory.  Key ``j`` of sequence ``b`` counts when
  ``0 <= k_pos[b, j] <= cur_pos[b]`` and, with a window, ``k_pos[b, j] >
  cur_pos[b] - window``: the reference's `decode_attention` for any slot
  order (ring, windowed, per-sequence caches).  The C slots are cut into
  `decode_splits` chunks planned from C alone (no position is read on the
  host), so that the grid fills the card; a 32-slot tile's positions are
  read before its K/V, and a tile without a valid key copies no K/V.  Each
  block writes its unnormalised (m, l, acc) to an fp32 workspace and a
  combine kernel merges the chunks in a fixed order (bitwise repeatable).
  P stays fp32.  Bound: bytes (the valid cache rows and the positions
  read once).  `flash_attention_kernel` with ``Sq == 1`` (whisper's
  decode cross-attention, a one-token prompt) runs the same kernel, its
  query at position 0 and slot ``j`` holding position ``j`` below
  ``sk_valid`` (`_one_token_positions`, made once a shape).
- fp32 with ``Sq > 1`` — the CUDA-core kernel (``launches_fp32``): fp32
  products have no tensor-core form without TF32, which the port's fp32
  parity rule excludes.

The training forward asks the prefill kernels for each row's fp32
log-sum-exp ``lse [B, Hq, Sq]`` (``m + log l`` at finalize, in both the
tensor-core and the fp32 kernel); serving does not, and its launches are
unchanged.  The backward (`flash_attention_bwd_kernel`,
``csrc/flash_attention_bwd.cu``) recomputes ``P = exp(scale·QKᵀ − lse)``
tile by tile and returns dQ, dK, dV: ``D = rowsum(dO∘O)``, a dK/dV kernel
with one block per (batch, kv head, 64-key tile) that walks the group's q
heads × the live Q steps (GQA's sum inside the block), and a dQ kernel
with one block per (batch, q head, 64-row tile) walking the live key
steps; each recomputes S and dP (7 products a live pair, 5 at least).  bf16 runs every product on ``wgmma`` (fp32 accumulators): ``Sᵀ
= K Qᵀ`` and ``dPᵀ = V dOᵀ`` from shared memory, then ``dV += Pᵀ dO``,
``dK += dSᵀ Q`` (and ``dQ += dS K``) with ``Pᵀ``, ``dSᵀ`` as register
operands and dO, Q, K read MN-major through the transpose bit, so no
transposed copy is made; the streamed side lands by TMA through a
double-buffered ring while the products run (steps of 128 rows or keys
at hd <= 64 past 128 of them, else 64), and two one-warpgroup blocks
share an SM so that one's exponentials overlap the other's products.
P and dS are rounded to bf16 for the three products.
Bound: bytes at smollm's and qwen3's training shapes, operations (5
products a live pair) at whisper's 1500-long encoder; two exponentials
a pair on the SFU and the elementwise work between the products keep
it above.  `flash_bwd_plan` gives the tiling (it never reads the batch:
a batch of folded cells gives each cell its own bits).  fp32 runs on the
CUDA cores in fp32.  No atomics (bitwise repeatable).  One call (three
launches) counts one launch.  The backward takes no ``sk_valid``.
`FlashAttentionFn` is the autograd `Function`
(forward: the kernel with ``lse``; backward: this kernel), which
`kernels.ops.flash_attention` takes when an input requires grad.

`flash_attention_plain` is the plain PyTorch version (CPU tensors and
tests): the naive attention with the same masks; `flash_decode_plain` the
decode's (the reference's `decode_attention` in plain torch ops, which
`models.attention` names `decode_attention_plain`);
`flash_attention_bwd_plain` the backward's formula in plain torch ops
(tests).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _visible(sq: int, sk: int, causal: bool, window: int, sk_valid, device):
    """[Sq, Sk] bool: key j counts for query i."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = k_pos < (sk if sk_valid is None else sk_valid)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          sk_valid=None, lse: bool = False):
    """Naive attention with the kernel's masks; fp32 math, out in q's type
    (and, with ``lse``, each row's fp32 log-sum-exp ``[B, Hq, Sq]``)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) \
        * (1.0 / math.sqrt(hd))
    ok = _visible(sq, sk, causal, window, sk_valid, q.device)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0):
    """The backward's formula in plain torch ops, fp32: ``P = exp(scale·
    QKᵀ − lse)`` (0 where masked), ``D = rowsum(dO∘O)``, ``dV = Pᵀ dO``,
    ``dS = P∘(dO Vᵀ − D)``, ``dQ = scale·dS K``, ``dK = scale·dSᵀ Q``, the
    GQA group summed; returns (dq, dk, dv) in the inputs' type."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qf, dof, of = q.float(), do.float(), o.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    ok = _visible(sq, sk, causal, window, None, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dvec = (dof * of).sum(dim=-1).transpose(1, 2)           # [B, Hq, Sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def fold(t):   # the GQA group's heads summed onto their kv head
        return t.reshape(b, sk, hkv, g, hd).sum(dim=3)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


DECODE_TILE = 32      # keys per tile of the split-KV kernel
H100_SMS = 132


def decode_rows(group: int) -> int:
    """Query rows of one GQA group that a split-KV block takes (2 or 8)."""
    return 2 if group <= 2 else 8


def decode_splits(lanes: int, slots: int, sms: int = H100_SMS):
    """(splits, chunk) of the split-KV decode: the ``slots`` cache slots
    of each of ``lanes`` (batch × kv head × row group)
    are cut into ``splits`` chunks of ``chunk`` slots, a multiple of the
    32-slot tile, every chunk non-empty, so that ``lanes · splits`` fills
    ``sms`` SMs at least twice where the slots allow it.  The plan depends
    on shapes only, never on the positions the cache holds."""
    if slots <= 0:
        return 1, DECODE_TILE
    tiles = -(-slots // DECODE_TILE)
    want = max(1, min(-(-2 * sms // max(lanes, 1)), tiles))
    chunk = tiles // want * DECODE_TILE      # at least `want` splits
    return -(-slots // chunk), chunk


@functools.lru_cache(maxsize=None)
def _decode_plan(b: int, hkv: int, group: int, slots: int, index: int):
    """(rows, splits, chunk) of the split-KV decode on card ``index``."""
    rows = decode_rows(group)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (rows, *decode_splits(b * hkv * -(-group // rows), slots, sms))


@functools.lru_cache(maxsize=1)
def _symbols():
    lib = build.load("flash_attention")
    simt, tc, dec = (lib.repro_flash_attention, lib.repro_flash_attention_tc,
                     lib.repro_flash_decode)
    simt.argtypes = tc.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int64] * 9
                                   + [ctypes.c_float, ctypes.c_void_p,
                                      ctypes.c_void_p])
    dec.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    for fn in (simt, tc, dec):
        fn.restype = ctypes.c_int
    return simt, tc, dec


def _check(q, k, v, name: str):
    """(b, sq, hq, hd, sk, hkv) of a kernel call; raises on what the
    kernels do not take."""
    dev, dt = q.device, q.dtype
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} takes CUDA tensors on one "
                         f"device, got {dev}, {k.device}, {v.device}")
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"{name} takes q, k, v all fp32 or "
                         f"all bf16, got {dt}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape or ks[0] != qs[0] \
            or ks[3] != qs[3] or qs[2] % ks[2] != 0:
        raise ValueError(f"shapes q{tuple(qs)} k{tuple(ks)} "
                         f"v{tuple(v.shape)} are not [B,Sq,Hq,hd] and "
                         "[B,Sk,Hkv,hd] with Hkv dividing Hq")
    if qs[3] not in HEAD_DIMS:
        raise ValueError(f"{name} takes hd in {HEAD_DIMS}, got {qs[3]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"{name} reads q, k and v in 16-byte vectors: "
                         "their data must be 16-byte aligned")
    return (*qs, ks[1], ks[2])


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           sk_valid=None, lse: bool = False):
    """Attention on the card.  q ``[B, Sq, Hq, hd]``, k/v ``[B, Sk, Hkv,
    hd]``, contiguous and 16-byte aligned, all fp32 or all bf16, hd in
    32/64/96/128; ``sk_valid`` a Python int in ``[0, Sk]``.  Returns a new
    tensor in q's type — with ``lse`` (prefill only), ``(out, lse)``, the
    rows' fp32 log-sum-exp ``[B, Hq, Sq]`` — and raises on anything else
    and on a refused launch.  One call is one counted launch
    (``launches``), and one of the path counts ``launches_tc``,
    ``launches_split_kv``, ``launches_fp32``."""
    b, sq, hq, hd, sk, hkv = _check(q, k, v, "flash_attention_kernel")
    dt = q.dtype
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    sk_valid = sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= sk or window < 0:
        raise ValueError(f"sk_valid {sk_valid} outside [0, {sk}] or window "
                         f"{window} < 0")
    if lse and sq == 1:
        raise ValueError("flash_attention_kernel writes lse on the prefill "
                         "paths (Sq > 1) only")
    if sq == 1:
        return flash_decode_kernel(q, k, v, *_one_token_positions(
            b, sk, sk_valid, causal, q.device.index))
    out = torch.empty_like(q)
    lse_t = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    lp = lse_t.data_ptr() if lse else None
    simt, tc, _ = _symbols()
    scale = 1.0 / math.sqrt(hd)
    index = q.device.index
    with device_scope(index):
        stream = raw_stream(index)
        if dt == torch.bfloat16:
            path = "tc"
            err = tc(qp, kp, vp, out.data_ptr(), b, sq, sk, hq, hkv, hd,
                     int(causal), int(window), sk_valid, scale, lp, stream)
        else:
            path = "fp32"
            err = simt(qp, kp, vp, out.data_ptr(), b, sq, sk, hq, hkv, hd,
                       int(causal), int(window), sk_valid, scale, lp, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({path}) launch failed: "
                           f"CUDA error {err} at q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    flash_attention_kernel.launches += 1
    if path == "tc":
        flash_attention_kernel.launches_tc += 1
    else:
        flash_attention_kernel.launches_fp32 += 1
    return (out, lse_t) if lse else out


@functools.lru_cache(maxsize=32)
def _one_token_positions(b: int, sk: int, sk_valid: int, causal: bool,
                         index: int):
    """(k_pos, cur_pos) on card ``index`` that make the stored-position
    decode compute a one-token query's attention (whisper's decode
    cross-attention, a one-token prompt): the query at position 0, slot j
    holding position j below ``sk_valid`` (-1 past it), so causal or not,
    key 0 alone or ``[0, sk_valid)`` count.  Made once a shape."""
    slots = torch.arange(sk, dtype=torch.int32, device=f"cuda:{index}")
    k_pos = torch.where(slots < sk_valid, slots, -1).expand(b, sk)
    cur = torch.full((b,), 0 if causal else sk, dtype=torch.int32,
                     device=slots.device)
    return k_pos.contiguous(), cur


def flash_decode_plain(q, k_cache, v_cache, k_pos, cur_pos, *, window=0):
    """Single-token decode: q [B, 1, Hq, hd] against a (possibly ring)
    cache [B, C, Hkv, hd], masked by the positions stored in the cache.

    ``k_pos`` [B, C]: absolute position stored in each cache slot (-1 =
    empty).  ``cur_pos`` [B]: position of the query token (its k/v already
    written).  Products of the working type accumulate in fp32; the
    probabilities are rounded to the cache's type before the PV product,
    as in the reference's `decode_attention`.
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, hkv, n_rep, hd).float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache.float()) * scale
    valid = (k_pos >= 0) & (k_pos <= cur_pos[:, None])
    if window:
        valid = valid & (k_pos > cur_pos[:, None] - window)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def flash_decode_kernel(q, k_cache, v_cache, k_pos, cur_pos, *,
                        window: int = 0):
    """Decode attention on the card: q ``[B, 1, Hq, hd]`` against the cache
    k, v ``[B, C, Hkv, hd]`` (contiguous, 16-byte aligned, all fp32 or all
    bf16, hd in 32/64/96/128), each slot masked by the position it holds,
    ``k_pos [B, C]``, against the query's ``cur_pos [B]`` and ``window``
    (0 = none): the function of `flash_decode_plain`.  ``k_pos`` and
    ``cur_pos`` stay on the card (int32; other integer types are cast
    there); nothing is read back.  Returns a new tensor in q's type and
    raises on anything else and on a refused launch.  One call is one
    counted launch (``flash_attention_kernel.launches`` and
    ``launches_split_kv``)."""
    b, sq, hq, hd, c, hkv = _check(q, k_cache, v_cache, "flash_decode_kernel")
    if sq != 1:
        raise ValueError(f"flash_decode_kernel takes one query token, got "
                         f"q{tuple(q.shape)}")
    if tuple(k_pos.shape) != (b, c) or tuple(cur_pos.shape) != (b,) \
            or k_pos.device != q.device or cur_pos.device != q.device \
            or k_pos.is_floating_point() or cur_pos.is_floating_point():
        raise ValueError(f"k_pos must be an integer [{b}, {c}] and cur_pos "
                         f"an integer [{b}] on {q.device}, got "
                         f"{tuple(k_pos.shape)} {k_pos.dtype} on "
                         f"{k_pos.device}, {tuple(cur_pos.shape)} "
                         f"{cur_pos.dtype} on {cur_pos.device}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    k_pos = k_pos.to(torch.int32).contiguous()
    cur_pos = cur_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _, _, dec = _symbols()
    index = q.device.index
    rows, splits, chunk = _decode_plan(b, hkv, hq // hkv, c, index)
    ws = torch.empty(b * hq * splits * (hd + 2), device=q.device,
                     dtype=torch.float32)
    with device_scope(index):
        err = dec(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  k_pos.data_ptr(), cur_pos.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), b, c, hq, hkv, hd, int(window), splits,
                  chunk, rows, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
                  raw_stream(index))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel (split_kv) launch "
                           f"failed: CUDA error {err} at q{tuple(q.shape)} "
                           f"cache{tuple(k_cache.shape)} {q.dtype}")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_split_kv += 1
    return out


# The bf16 backward's tiling (``csrc/flash_attention_bwd.cu``, namespace
# ``tcb``; the names of its constants beside each): one warpgroup a block,
# 64 keys (dK/dV) or 64 rows (dQ), two blocks an SM.
BWD_THREADS = 128           # THREADS
BWD_BLOCKS_PER_SM = 2       # BLOCKS
BWD_KEYS = 64               # BKV: keys a dK/dV block
BWD_ROWS = 64               # BQQ: query rows a dQ block
BWD_STAGES = 2              # STAGES: the TMA ring (double buffer)
BWD_LONG = 128              # LONG: a pass streaming more takes 128 steps


def bwd_step(hd: int, length: int) -> int:
    """Query rows (dK/dV) or keys (dQ) a step streams (``tcb::tc_step``),
    from the pass's streamed length (``sq`` for dK/dV, ``sk`` for dQ): 128
    at hd <= 64 past `BWD_LONG`, else 64."""
    return 128 if hd <= 64 and length > BWD_LONG else 64


def bwd_q_range(k0: int, sq: int, sk: int, causal: bool, window: int):
    """Query rows ``[begin, end)`` that the dK/dV block of keys ``[k0, k0 +
    BWD_KEYS)`` walks, in `bwd_step` steps from ``begin`` (the kernel's
    ``q_begin``, ``q_end``): causal rows from ``k0``, windowed rows below
    the block's last key + window."""
    begin = k0 if causal else 0
    end = sq
    if window:
        end = min(end, min(k0 + BWD_KEYS, sk) - 1 + window)
    return begin, max(begin, end)


def bwd_k_range(q0: int, sq: int, sk: int, causal: bool, window: int,
                step: int):
    """Keys ``[begin, end)`` that the dQ block of rows ``[q0, q0 +
    BWD_ROWS)`` walks, in ``step`` steps from ``begin`` (the kernel's
    ``k_begin``, ``k_end``): causal keys up to the block's last row,
    windowed keys from its first row − window + 1, that key's step
    rounded down."""
    end = sk
    if causal:
        end = min(end, min(q0 + BWD_ROWS, sq))
    lo = max(0, q0 - window + 1) if window else 0
    if lo >= end:
        return 0, 0
    return lo // step * step, end


def flash_bwd_plan(sq: int, sk: int, hq: int, hkv: int, hd: int,
                   causal: bool, window: int) -> dict:
    """The bf16 backward's launch plan, which depends on these arguments
    alone (never on the batch, so a batch folded from cells runs each cell
    as it would run alone): head dim as held in shared memory, each pass's
    step, threads, shared-memory bytes and grid (without its batch axis)
    of the dK/dV and dQ kernels, and the steps of the block that walks the
    most.  It mirrors the constants of namespace ``tcb``, which
    ``tests/test_torch_flash_bwd_plan.py`` reads back from the source."""
    hdp = 64 if hd <= 64 else 128
    nq, nk = bwd_step(hd, sq), bwd_step(hd, sk)
    tile = 2 * hdp                                    # bytes a row
    # the tiles, each stage's lse and D (dK/dV) and its 8-byte mbarrier
    dkdv_smem = (1024 + 2 * BWD_KEYS * tile
                 + BWD_STAGES * (2 * nq * tile + 2 * nq * 4 + 8))
    dq_smem = 1024 + 2 * BWD_ROWS * tile + BWD_STAGES * (2 * nk * tile + 8)
    key_blocks, row_blocks = -(-sk // BWD_KEYS), -(-sq // BWD_ROWS)
    dkdv_steps = max((-(-(e - s) // nq) for s, e in (
        bwd_q_range(i * BWD_KEYS, sq, sk, causal, window)
        for i in range(key_blocks))), default=0) * (hq // hkv)
    dq_steps = max((-(-(e - s) // nk) for s, e in (
        bwd_k_range(i * BWD_ROWS, sq, sk, causal, window, nk)
        for i in range(row_blocks))), default=0)
    return dict(hdp=hdp, dkdv_step=nq, dq_step=nk, threads=BWD_THREADS,
                stages=BWD_STAGES, blocks_per_sm=BWD_BLOCKS_PER_SM,
                dkdv_smem=dkdv_smem, dq_smem=dq_smem,
                dkdv_grid=(key_blocks, hkv), dq_grid=(row_blocks, hq),
                dkdv_steps=dkdv_steps, dq_steps=dq_steps)


@functools.lru_cache(maxsize=1)
def _bwd_symbol():
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                               window: int = 0):
    """dQ, dK, dV on the card from the forward's ``o`` and ``lse`` and the
    output gradient ``do`` (q's shape and type).  Takes what the forward
    takes, without ``sk_valid``; raises on anything else and on a refused
    launch.  One call (three launches) is one counted launch."""
    b, sq, hq, hd, sk, hkv = _check(q, k, v, "flash_attention_bwd_kernel")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or not (o.is_contiguous()
                                           and do.is_contiguous()) \
            or (o.data_ptr() | do.data_ptr()) % 16:
        raise ValueError("o and do must be contiguous, 16-byte aligned, "
                         "of q's shape and type")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{b}, {hq}, {sq}]")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    ws = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    index = q.device.index
    with device_scope(index):
        err = _bwd_symbol()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, hd,
            int(causal), int(window), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], raw_stream(index))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} at q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the hand-written forward (with ``lse``) and backward
    kernels; ``apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


PATHS = ("tc", "split_kv", "fp32")


def path_launches() -> dict:
    """Launches of each of the three kernels since the last reset."""
    return {p: getattr(flash_attention_kernel, f"launches_{p}")
            for p in PATHS}


def reset_path_launches() -> None:
    for p in PATHS:
        setattr(flash_attention_kernel, f"launches_{p}", 0)


flash_attention_kernel.launches = 0
reset_path_launches()
