"""Layered decoder stacks built from typed blocks.  Port of
`repro.models.transformer` for the families the port serves (DENSE, SSM).

A model is a **program**: a super-block (a short list of typed layers)
repeated ``R`` times.  Parameters keep the reference's nested dict,
``{"l{li}": {"b{bi}": {leaf: [R, ...]}}}``, so `repro_torch.convert`
carries weights across leaf for leaf; the stack is a plain Python loop
over the R repeats (no scan).  Caches have the same ``[R, ...]`` layout.

Block types ported: ``attn`` (causal self-attention, GQA + RoPE + qk-norm
+ sliding window), ``ffn`` (SwiGLU), ``mlstm``, ``slstm``.  The MOE,
HYBRID, AUDIO and VLM families and the ``moe``/``mamba``/``xattn``/
``ffn_gelu``/``attn_nc`` blocks raise `NotImplementedError`
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, DENSE, SSM
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.utils.tree import tree_map

F32 = torch.float32
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 7: MoE, "
        "hybrid/mamba, enc-dec and VLM token models)")


# ---------------------------------------------------------------------------
# Program construction
# ---------------------------------------------------------------------------

def layer_program(cfg: ModelConfig) -> tuple:
    """Returns (super_block, repeats) where super_block is a list of layers,
    each layer a tuple of block-type strings."""
    if cfg.family == SSM:
        pattern = []
        for part in cfg.ssm_pattern.split(","):
            if "*" in part:
                name, cnt = part.split("*")
                pattern += [(name,)] * int(cnt)
            else:
                pattern += [(part,)]
        period = len(pattern)
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.n_layers} layers is not a multiple of "
                             f"the pattern period {period}")
        return pattern, cfg.n_layers // period
    if cfg.family == DENSE:
        return [("attn", "ffn")], cfg.n_layers
    raise _unported(f"the {cfg.family!r} family")


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, dtype, device, lead) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "norm": torch.ones((*lead, d), dtype=F32, device=device),
        "wq": L.dense_init(gen, d, cfg.n_heads * hd, dtype, device, lead),
        "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead),
        "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead),
        "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype, device, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=F32, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=F32, device=device)
    return p


def block_init(gen, kind: str, cfg: ModelConfig, device=None, lead=()) -> dict:
    """One block's parameters, each leaf stacked ``[*lead, ...]``."""
    dtype = torch_dtype(cfg)
    d = cfg.d_model
    if kind == "attn":
        return _attn_init(gen, cfg, dtype, device, lead)
    if kind == "ffn":
        return {
            "w_gate": L.dense_init(gen, d, cfg.d_ff, dtype, device, lead),
            "w_up": L.dense_init(gen, d, cfg.d_ff, dtype, device, lead),
            "w_down": L.dense_init(gen, cfg.d_ff, d, dtype, device, lead),
            "norm": torch.ones((*lead, d), dtype=F32, device=device),
        }
    if kind == "mlstm":
        return S.mlstm_init(gen, d, cfg.n_heads, dtype, device, lead)
    if kind == "slstm":
        return S.slstm_init(gen, d, cfg.n_heads, dtype, device, lead)
    raise _unported(f"the {kind!r} block")


# ---------------------------------------------------------------------------
# Block forward (full sequence)
# ---------------------------------------------------------------------------

def _qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q = (xn @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (xn @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (xn @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def block_fwd(kind: str, p: dict, x, cfg: ModelConfig, ctx: dict):
    """Returns the block's delta; the caller adds the residual."""
    b, s, _ = x.shape
    if kind == "attn":
        q, k, v = _qkv(p, cfg, x, ctx["positions"])
        window = ctx.get("window", cfg.sliding_window)
        o = A.attention(q, k, v, causal=cfg.causal,
                        window=window if cfg.causal else 0)
        return o.reshape(b, s, -1) @ p["wo"]
    if kind == "ffn":
        return L.swiglu(p, L.rmsnorm(x, p["norm"], cfg.norm_eps))
    if kind == "mlstm":
        return S.mlstm_block(p, x, cfg.n_heads, cfg.norm_eps)
    if kind == "slstm":
        return S.slstm_block(p, x, cfg.n_heads, cfg.norm_eps)
    raise _unported(f"the {kind!r} block")


def layer_fwd(layer: tuple, params: dict, x, cfg: ModelConfig, ctx: dict):
    """One layer = sequence of blocks, each with a residual connection."""
    for bi, kind in enumerate(layer):
        x = x + block_fwd(kind, params[f"b{bi}"], x, cfg, ctx)
    return x


# ---------------------------------------------------------------------------
# Stack init / forward (a loop over the R stacked super-blocks)
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ModelConfig, program, repeats: int,
               device=None) -> dict:
    """Params ``{"l{li}": {"b{bi}": {leaf: [R, ...]}}}``."""
    return {f"l{li}": {f"b{bi}": block_init(gen, kind, cfg, device,
                                            (repeats,))
                       for bi, kind in enumerate(layer)}
            for li, layer in enumerate(program)}


def repeat_slice(stacked: dict, r: int) -> dict:
    """Repetition ``r`` of an ``[R, ...]``-stacked tree (views)."""
    return tree_map(lambda a: a[r], stacked)


def n_repeats(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = leaf[next(iter(leaf))]
    return leaf.shape[0]


def stack_fwd(stacked: dict, x, cfg: ModelConfig, program, ctx: dict):
    for r in range(n_repeats(stacked)):
        rep = repeat_slice(stacked, r)
        for li, layer in enumerate(program):
            x = layer_fwd(layer, rep[f"l{li}"], x, cfg, ctx)
    return x


# ---------------------------------------------------------------------------
# Caches (decode)
# ---------------------------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     device, lead):
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, cache_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((*lead, batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def layer_cache_init(layer: tuple, cfg: ModelConfig, batch: int,
                     cache_len: int, window: int, dtype, device=None,
                     lead=()) -> dict:
    out = {}
    eff_len = min(cache_len, window) if window else cache_len
    for bi, kind in enumerate(layer):
        if kind == "attn":
            out[f"b{bi}"] = _attn_cache_init(cfg, batch, eff_len, dtype,
                                             device, lead)
        elif kind == "mlstm":
            d_in = 2 * cfg.d_model
            out[f"b{bi}"] = S.mlstm_decode_init(
                batch, cfg.n_heads, d_in // cfg.n_heads, device, lead)
        elif kind == "slstm":
            out[f"b{bi}"] = S.slstm_decode_init(
                batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device, lead)
        elif kind != "ffn":
            raise _unported(f"the {kind!r} block's cache")
    return out


def cache_init(cfg: ModelConfig, batch: int, cache_len: int,
               window: int = None, device=None) -> dict:
    """Stacked ``[R, ...]`` cache tree for the whole decoder stack."""
    program, repeats = layer_program(cfg)
    window = cfg.sliding_window if window is None else window
    return {f"l{li}": layer_cache_init(layer, cfg, batch, cache_len, window,
                                       torch_dtype(cfg), device, (repeats,))
            for li, layer in enumerate(program)}


# ---------------------------------------------------------------------------
# Decode step (single token) through the stacked program
# ---------------------------------------------------------------------------

def block_decode(kind: str, p: dict, x, cache, cfg: ModelConfig, ctx: dict):
    """Returns (delta, new cache).  The attention cache is written in
    place (the JAX reference returns an updated copy); the recurrent
    states come back as new tensors."""
    b = x.shape[0]
    if kind == "attn":
        hd = cfg.resolved_head_dim
        pos = ctx["positions"]                    # [B]
        xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
        q = (xn @ p["wq"]).reshape(b, 1, cfg.n_heads, hd)
        k = (xn @ p["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
        v = (xn @ p["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
            k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
        q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
        slot = pos % cache["k"].shape[1]          # ring write
        bidx = torch.arange(b, device=x.device)
        cache["k"][bidx, slot] = k[:, 0]
        cache["v"][bidx, slot] = v[:, 0]
        cache["pos"][bidx, slot] = pos.to(torch.int32)
        window = ctx.get("window", cfg.sliding_window)
        o = A.decode_attention(q, cache["k"], cache["v"], cache["pos"], pos,
                               window=window, kv_len=ctx.get("kv_len"))
        return o.reshape(b, 1, -1) @ p["wo"], cache
    if kind == "ffn":
        return block_fwd(kind, p, x, cfg, ctx), cache
    if kind == "mlstm":
        return S.mlstm_block_decode(p, x, cache, cfg.n_heads, cfg.norm_eps)
    if kind == "slstm":
        return S.slstm_block_decode(p, x, cache, cfg.n_heads, cfg.norm_eps)
    raise _unported(f"the {kind!r} block")


def stack_decode(stacked: dict, caches: dict, x, cfg: ModelConfig, program,
                 ctx: dict):
    """One token through the stack; ``caches`` is updated in place and
    returned."""
    for r in range(n_repeats(stacked)):
        rep, rep_cache = repeat_slice(stacked, r), repeat_slice(caches, r)
        for li, layer in enumerate(program):
            for bi, kind in enumerate(layer):
                key = f"b{bi}"
                cache_b = rep_cache[f"l{li}"].get(key)
                delta, new_c = block_decode(kind, rep[f"l{li}"][key], x,
                                            cache_b, cfg, ctx)
                x = x + delta
                if cache_b is not None and new_c is not cache_b:
                    tree_map(lambda dst, src: dst.copy_(src), cache_b, new_c)
    return x, caches


# ---------------------------------------------------------------------------
# Prefill: full forward that also writes caches
# ---------------------------------------------------------------------------

def stack_prefill(stacked: dict, caches: dict, x, cfg: ModelConfig, program,
                  ctx: dict):
    """Run the full sequence and write the attention caches (in place).

    As in the reference, the mLSTM/sLSTM caches are left as initialized:
    decode after prefill starts those blocks from the empty state."""
    b, s, _ = x.shape
    for r in range(n_repeats(stacked)):
        rep, rep_cache = repeat_slice(stacked, r), repeat_slice(caches, r)
        for li, layer in enumerate(program):
            for bi, kind in enumerate(layer):
                key = f"b{bi}"
                p = rep[f"l{li}"][key]
                cache_b = rep_cache[f"l{li}"].get(key)
                if kind == "attn" and cache_b is not None:
                    q, k, v = _qkv(p, cfg, x, ctx["positions"])
                    window = ctx.get("window", cfg.sliding_window)
                    o = A.attention(q, k, v, causal=cfg.causal, window=window)
                    delta = o.reshape(b, s, -1) @ p["wo"]
                    take = min(cache_b["k"].shape[1], s)
                    cache_b["k"][:, :take] = k[:, s - take:]
                    cache_b["v"][:, :take] = v[:, s - take:]
                    cache_b["pos"][:, :take] = torch.arange(
                        s - take, s, dtype=torch.int32, device=x.device)
                else:
                    delta = block_fwd(kind, p, x, cfg, ctx)
                x = x + delta
    return x, caches
