"""Layered decoder/encoder stacks built from typed blocks.  Port of
`repro.models.transformer`.

A model is a **program**: a super-block (a short list of typed layers)
repeated ``R`` times.  Parameters keep the reference's nested dict,
``{"l{li}": {"b{bi}": {leaf: [R, ...]}}}``, so `repro_torch.convert`
carries weights across leaf for leaf; the stack is a plain Python loop
over the R repeats (no scan).  Caches have the same ``[R, ...]`` layout.

Block types: ``attn`` (self, causal or not, GQA + RoPE + qk-norm +
sliding window), ``attn_nc`` (the encoder's non-causal self-attention),
``xattn`` (cross-attention to the encoder output), ``ffn`` (SwiGLU),
``ffn_gelu``, ``moe``, ``mamba``, ``mlstm``, ``slstm``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, AUDIO, HYBRID, MOE, SSM
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.utils.tree import tree_map

F32 = torch.float32
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


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
        return pattern, _repeats(cfg, len(pattern))
    if cfg.family == HYBRID:
        period = cfg.attn_every
        sb = []
        for i in range(period):
            mixer = "attn" if i == period - 1 else "mamba"
            ffn = "moe" if (cfg.n_experts and i % cfg.moe_every == 1) else "ffn"
            sb.append((mixer, ffn))
        return sb, _repeats(cfg, period)
    if cfg.family == MOE:
        period = cfg.moe_every
        sb = [("attn", "moe" if i == period - 1 else "ffn")
              for i in range(period)]
        return sb, _repeats(cfg, period)
    if cfg.family == AUDIO:  # decoder program (encoder: `encoder_program`)
        return [("attn", "xattn", "ffn_gelu")], cfg.n_layers
    # dense / vlm
    return [("attn", "ffn")], cfg.n_layers


def _repeats(cfg: ModelConfig, period: int) -> int:
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers is not a multiple of "
                         f"the pattern period {period}")
    return cfg.n_layers // period


def encoder_program(cfg: ModelConfig) -> tuple:
    return [("attn_nc", "ffn_gelu")], cfg.n_encoder_layers


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
    norm = {"norm": torch.ones((*lead, d), dtype=F32, device=device)}
    if kind in ("attn", "attn_nc", "xattn"):
        return _attn_init(gen, cfg, dtype, device, lead)
    if kind == "ffn":
        return {**L.swiglu_init(gen, d, cfg.d_ff, dtype, device, lead),
                **norm}
    if kind == "ffn_gelu":
        return {**L.gelu_mlp_init(gen, d, cfg.d_ff, dtype, device, lead),
                **norm}
    if kind == "moe":
        return {**M.moe_init(gen, d, cfg.resolved_d_ff_expert, cfg.n_experts,
                             dtype, device, lead), **norm}
    if kind == "mamba":
        return MB.mamba_init(gen, d, expand=cfg.ssm_expand,
                             state_dim=cfg.ssm_state_dim,
                             conv_dim=cfg.ssm_conv_dim, dtype=dtype,
                             device=device, lead=lead)
    if kind == "mlstm":
        return S.mlstm_init(gen, d, cfg.n_heads, dtype, device, lead)
    if kind == "slstm":
        return S.slstm_init(gen, d, cfg.n_heads, dtype, device, lead)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block forward (full sequence)
# ---------------------------------------------------------------------------

def _qkv(p, cfg, x, positions, cell=None):
    """q, k, v ``[*lead, S, H, hd]`` of ``x [*lead, S, d]``; with
    client-stacked weights (``[N, ...]``) ``lead`` is ``(N, b)``.
    ``cell``: the grid's cell size (`block_fwd`)."""
    *lead, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps, cell)
    q = L.mm(xn, p["wq"], cell).reshape(*lead, s, cfg.n_heads, hd)
    k = L.mm(xn, p["wk"], cell).reshape(*lead, s, cfg.n_kv_heads, hd)
    v = L.mm(xn, p["wv"], cell).reshape(*lead, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps, cell)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps, cell)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _fold(t):
    """``[*lead, S, H, hd]`` -> ``[prod(lead), S, H, hd]``: the client axis
    folds into attention's batch, one kernel launch for every client."""
    return t.reshape(-1, *t.shape[-3:])


def _xattn_kv(p, cfg, enc):
    """Cross-attention K, V ``[*lead, Senc, Hkv, hd]`` of the encoder
    output ``enc [*lead, Senc, d]`` (``lead`` is ``(N, b)`` on
    client-stacked weights: each client's rows of the encoder output)."""
    *lead, se, _ = enc.shape
    hd = cfg.resolved_head_dim
    return (L.mm(enc, p["wk"]).reshape(*lead, se, cfg.n_kv_heads, hd),
            L.mm(enc, p["wv"]).reshape(*lead, se, cfg.n_kv_heads, hd))


def _xattn(p, cfg, x, k, v):
    *lead, s, _ = x.shape
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q = L.mm(xn, p["wq"]).reshape(*lead, s, cfg.n_heads,
                                  cfg.resolved_head_dim)
    o = A.attention(_fold(q), _fold(k), _fold(v), causal=False, window=0)
    return L.mm(o.reshape(*x.shape[:-1], -1), p["wo"])


def _moe(p, cfg, x, lb: bool, cell=None):
    """The MoE block's delta and, with ``lb``, its load-balance loss
    (``[N]`` on client-stacked weights; else None).  Serving's prefill and
    decode ask for no loss, so they skip its math unless `moe.RECORD`
    records the aux."""
    record = M.RECORD is not None
    out, aux = M.moe_ffn(p, L.rmsnorm(x, p["norm"], cfg.norm_eps, cell),
                         top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         return_aux=lb or record, cell_size=cell)
    if record:
        M.RECORD.append(aux)
    return out, aux["lb_loss"] if lb else None


def block_fwd(kind: str, p: dict, x, cfg: ModelConfig, ctx: dict,
              lb: bool = False):
    """Returns ``(delta, aux)``; the caller adds the residual.  ``aux`` is
    an MoE block's load-balance loss when ``lb`` asks for it, else None.
    Every block also takes client-stacked weights (leaves ``[N, ...]``)
    with ``x [N, b, S, d]``: the port's form of the reference's vmap over
    clients.  ``ctx["cell_size"]`` (the grid runner's N, where the client
    axis folds G cells) runs every op whose plan may follow the leading
    extent once per cell — the products, the MoE, mamba and xLSTM blocks
    — and plans the norms on one cell's rows; attention and the elementwise ops
    run once over the fold (cross-attention takes no cell size: whisper's
    Session raises before it)."""
    cell = ctx.get("cell_size")
    if kind in ("attn", "attn_nc"):
        causal = kind == "attn" and cfg.causal
        q, k, v = _qkv(p, cfg, x, ctx["positions"], cell)
        window = ctx.get("window", cfg.sliding_window)
        o = A.attention(_fold(q), _fold(k), _fold(v), causal=causal,
                        window=window if causal else 0)
        return L.mm(o.reshape(*x.shape[:-1], -1), p["wo"], cell), None
    if kind == "xattn":
        return _xattn(p, cfg, x, *_xattn_kv(p, cfg, ctx["enc_out"])), None
    if kind == "ffn":
        return L.swiglu(p, L.rmsnorm(x, p["norm"], cfg.norm_eps, cell),
                        cell), None
    if kind == "ffn_gelu":
        return L.gelu_mlp(p, L.rmsnorm(x, p["norm"], cfg.norm_eps, cell),
                          cell), None
    if kind == "moe":
        return _moe(p, cfg, x, lb, cell)
    if kind == "mamba":
        return MB.mamba_block(p, x, state_dim=cfg.ssm_state_dim,
                              eps=cfg.norm_eps, cell_size=cell), None
    if kind == "mlstm":
        return S.mlstm_block(p, x, cfg.n_heads, cfg.norm_eps,
                             cell_size=cell), None
    if kind == "slstm":
        return S.slstm_block(p, x, cfg.n_heads, cfg.norm_eps,
                             cell_size=cell), None
    raise ValueError(kind)


def layer_fwd(layer: tuple, params: dict, x, cfg: ModelConfig, ctx: dict):
    """One layer = sequence of blocks, each with a residual connection;
    returns ``(x, aux)``, the layer's summed MoE load-balance losses (0.0
    without an MoE block), as the reference."""
    aux_sum = 0.0
    for bi, kind in enumerate(layer):
        delta, aux = block_fwd(kind, params[f"b{bi}"], x, cfg, ctx, lb=True)
        x = x + delta
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, aux_sum


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


def n_repeats(stacked: dict, axis: int = 0) -> int:
    """R of a stacked tree (its leaves' size along ``axis``: 1 for a
    client-stacked ``[N, R, ...]`` tree)."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = leaf[next(iter(leaf))]
    return leaf.shape[axis]


def unstack_params(stacked: dict, repeats: int) -> list:
    """``[R, ...]``-stacked tree -> list of R per-repetition trees (views)."""
    return [repeat_slice(stacked, r) for r in range(repeats)]


def stack_params(reps: list) -> dict:
    """List of per-repetition trees -> one ``[R, ...]``-stacked tree."""
    return tree_map(lambda *xs: torch.stack(xs), *reps)


def stack_fwd(stacked, x, cfg: ModelConfig, program, ctx: dict,
              remat: bool = False):
    """The stack over ``x``; returns ``(x, aux)``.

    ``stacked`` is the ``[R, ...]`` tree or a list of per-repetition
    trees (the simulator's units).  With ``x [N, b, S, d]`` every leaf
    carries the client axis ``[N, ...]``.  ``remat`` recomputes each
    super-block in the backward (`torch.utils.checkpoint`,
    non-reentrant), as the reference's ``jax.checkpoint(superblock)``; the
    super-block returns its aux, so the loss's gradient reaches the
    routers through the recomputation.  ``aux`` is the MoE load-balance
    losses summed per super-block and over the repetitions, as the
    reference's (``[N]`` on client-stacked weights; 0.0 without an MoE
    block)."""
    reps = stacked if isinstance(stacked, list) \
        else unstack_params(stacked, n_repeats(stacked))

    def superblock(x, rep):
        aux_total = 0.0
        for li, layer in enumerate(program):
            x, aux = layer_fwd(layer, rep[f"l{li}"], x, cfg, ctx)
            aux_total = aux_total + aux
        return x, aux_total

    aux = 0.0
    for rep in reps:
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(superblock, x, rep, use_reentrant=False)
        else:
            x, a = superblock(x, rep)
        aux = aux + a
    return x, aux


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
    hd = cfg.resolved_head_dim
    for bi, kind in enumerate(layer):
        if kind == "attn":
            out[f"b{bi}"] = _attn_cache_init(cfg, batch, eff_len, dtype,
                                             device, lead)
        elif kind == "xattn":
            shape = (*lead, batch, cfg.encoder_seq, cfg.n_kv_heads, hd)
            out[f"b{bi}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        elif kind == "mamba":
            out[f"b{bi}"] = MB.mamba_decode_init(
                batch, cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim,
                cfg.ssm_conv_dim, device, lead)
        elif kind == "mlstm":
            d_in = 2 * cfg.d_model
            out[f"b{bi}"] = S.mlstm_decode_init(
                batch, cfg.n_heads, d_in // cfg.n_heads, device, lead)
        elif kind == "slstm":
            out[f"b{bi}"] = S.slstm_decode_init(
                batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device, lead)
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
    if kind == "xattn":
        return _xattn(p, cfg, x, cache["k"], cache["v"]), cache
    if kind in ("ffn", "ffn_gelu", "moe"):
        return block_fwd(kind, p, x, cfg, ctx)[0], cache
    if kind == "mamba":
        return MB.mamba_block_decode(p, x, cache,
                                     state_dim=cfg.ssm_state_dim,
                                     eps=cfg.norm_eps)
    if kind == "mlstm":
        return S.mlstm_block_decode(p, x, cache, cfg.n_heads, cfg.norm_eps)
    if kind == "slstm":
        return S.slstm_block_decode(p, x, cache, cfg.n_heads, cfg.norm_eps)
    raise ValueError(kind)


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
    """Run the full sequence and write the attention caches and the
    cross-attention K/V of the encoder output (in place).

    As in the reference (its `stack_prefill` quirk, kept on purpose), the
    mamba, mLSTM and sLSTM caches are left as initialized: decode after
    prefill starts those blocks from the empty state."""
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
                elif kind == "xattn" and cache_b is not None:
                    k, v = _xattn_kv(p, cfg, ctx["enc_out"])
                    cache_b["k"].copy_(k)
                    cache_b["v"].copy_(v)
                    delta = _xattn(p, cfg, x, k, v)
                else:
                    delta, _ = block_fwd(kind, p, x, cfg, ctx)
                x = x + delta
    return x, caches
