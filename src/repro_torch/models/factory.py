"""Public model API: build_model(cfg) -> Model bundle.

Port of `repro.models.factory` for the CNN family (the simulator's
models) and every token family: ``init``, ``apply``, ``init_cache``,
``prefill`` and ``decode_step``.  The AUDIO family's encoder runs at
prefill on the batch's ``frame_embeddings`` (its cross-attention K/V go
into the cache); the VLM family merges ``patch_embeddings`` at the
``patch_mask`` positions.  Every token family also trains: ``loss`` (one
model), ``stacked_loss`` (the simulator's client-stacked units,
per-client losses, with the grid runner's folded cells) and
``split_loss`` (the SPMD step's client prefix and server suffix), each
adding the MoE blocks' load-balance loss as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, CNN, VLM
from repro_torch.models import cnn as C
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.cells import by_cell
from repro_torch.utils.tree import tree_map


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable          # (generator, device) -> params
    apply: Callable         # (params, batch) -> (logits, aux)
    loss: Callable          # (params, batch) -> (loss, metrics)
    init_cache: Callable    # (batch, cache_len, window=None, device=None) -> cache
    prefill: Callable       # (params, batch, cache_len=None) -> (logits, cache)
    decode_step: Callable   # (params, cache, batch) -> (logits, cache)
    # per-client losses [N] over [N, ...]-stacked params/batches; takes
    # ``cell_size=`` (a grid's N where cells fold into the leading axis)
    stacked_loss: Callable = None
    # HASFL split loss (client-stacked prefix, one server suffix; token
    # models)
    split_loss: Callable = None


# the reference's fold size of the cross-entropy (tokens of a sequence a
# chunk), as its ``REPRO_CE_CHUNK`` default
CE_CHUNK = 512


def _client_embed(emb, tokens):
    """Each client's rows of its own table: ``emb [N, V, d]``, ``tokens
    [N, b, S]`` -> ``[N, b, S, d]``, one gather over the flattened tables."""
    n, vocab, d = emb.shape
    offs = torch.arange(n, device=tokens.device)[:, None, None] * vocab
    return F.embedding(tokens.long() + offs, emb.reshape(n * vocab, d))


def _chunked_ce(x, head, labels, mask, per_client: bool = False):
    """Masked mean cross-entropy of ``x [..., S, d] @ head``, folded over
    `CE_CHUNK` positions at a time (the reference's ``_chunked_ce``;
    logits in fp32).  ``head`` is ``[d, V]``, or ``[N, d, V]`` with
    ``x [N, b, S, d]`` and ``per_client``: then each client's own mean,
    ``[N]``.  The mean is over the mask's ones (at least 1), or over every
    token without a mask."""
    s = x.shape[-2]
    cs = min(CE_CHUNK, s)
    if s % cs:
        cs = s
    lead = x.shape[0] if per_client else 1
    nll_sum = 0.0
    for c0 in range(0, s, cs):
        logits = L.mm(x[..., c0:c0 + cs, :], head).float()
        tgt = torch.gather(logits, -1,
                           labels[..., c0:c0 + cs, None].long())[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - tgt
        if mask is not None:
            nll = nll * mask[..., c0:c0 + cs]
        nll_sum = nll_sum + nll.reshape(lead, -1).sum(dim=1)
    if mask is None:
        total = float(labels[0].numel() if per_client else labels.numel())
    else:
        total = torch.clamp(mask.reshape(lead, -1).sum(dim=1), min=1.0)
    ce = nll_sum / total
    return ce if per_client else ce[0]


def _merge_patches(x, patch_embeddings, patch_mask):
    """Place patch embeddings (in order) at masked positions: x ``[*lead,
    S, d]``, patch_embeddings ``[*lead, P, d]``, patch_mask ``[*lead, S]``
    (``lead`` is ``(N, b)`` for client-stacked batches: each row merges
    its own patches)."""
    idx = patch_mask.to(torch.int64).cumsum(dim=-1) - 1
    idx = idx.clamp(0, patch_embeddings.shape[-2] - 1)
    gathered = torch.gather(
        patch_embeddings, -2,
        idx[..., None].expand(*idx.shape, patch_embeddings.shape[-1]))
    return torch.where(patch_mask[..., None], gathered.to(x.dtype), x)


def _client_reps(stacked: dict) -> list:
    """A client-stacked ``[N, R, ...]`` stack tree -> its R per-repetition
    trees of ``[N, ...]`` leaves (views)."""
    return [tree_map(lambda a, r=r: a[:, r], stacked)
            for r in range(T.n_repeats(stacked, axis=1))]


def _aux_total(aux):
    """The sum over clients of a client-stacked stack's aux (``[N]``, or
    0.0 without an MoE block)."""
    return aux.sum() if torch.is_tensor(aux) else aux


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == CNN:
        return _build_cnn(cfg)
    return _build_transformer(cfg)


# ---------------------------------------------------------------------------
# Transformer-family models
# ---------------------------------------------------------------------------

def _build_transformer(cfg: ModelConfig) -> Model:
    program, repeats = T.layer_program(cfg)
    dtype = T.torch_dtype(cfg)

    def init(gen, device=None):
        """Parameters ``{"embed", "stack", "final_norm"[, "head"][,
        "enc_stack", "enc_final_norm"]}`` drawn from ``gen`` (on the
        generator's device, then moved to ``device``)."""
        params = {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device),
            "stack": T.stack_init(gen, cfg, program, repeats, device),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
        }
        if not cfg.tie_embeddings:
            params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          dtype, device)
        if cfg.is_enc_dec:
            enc_prog, enc_reps = T.encoder_program(cfg)
            params["enc_stack"] = T.stack_init(gen, cfg, enc_prog, enc_reps,
                                               device)
            params["enc_final_norm"] = torch.ones(
                (cfg.d_model,), dtype=torch.float32, device=device)
        return params

    def _positions(s, device):
        """The sinusoidal table's first ``s`` rows, in the model's type."""
        return L.sinusoidal_table(s, cfg.d_model, dtype, device)

    def _encode(enc_stack, final_norm, frame_embeddings, shard_fn=None):
        """The encoder over ``frame_embeddings [*lead, Senc, d]``:
        ``enc_stack`` the ``[R, ...]`` tree, or the per-repetition list
        of client-stacked ``[N, ...]`` trees with ``lead`` ``(N, b)``."""
        enc_prog, _ = T.encoder_program(cfg)
        s = frame_embeddings.shape[-2]
        dev = final_norm.device
        x = torch.as_tensor(frame_embeddings, device=dev).to(dtype) \
            + _positions(s, dev)[None]
        x, _ = T.stack_fwd(enc_stack, x, cfg, enc_prog,
                           {"positions": torch.arange(s, device=dev)[None, :],
                            "shard_fn": shard_fn})
        return L.rmsnorm(x, final_norm, cfg.norm_eps)

    def _embed_inputs(emb, batch, cell=None):
        """The embedded inputs of ``batch``: ``emb [V, d]`` and tokens
        ``[B, S]``, or each client's own table ``emb [N, V, d]`` and
        tokens ``[N, b, S]`` (one gather a grid cell of ``cell`` clients:
        on the card the gather's backward picks its kernel by the index
        count).  VLM batches merge their patches; whisper adds its
        sinusoidal positions."""
        tokens = batch["tokens"]
        x = emb[tokens] if emb.dim() == 2 \
            else by_cell(_client_embed, cell, emb, tokens)
        if cfg.family == VLM and "patch_embeddings" in batch:
            x = _merge_patches(
                x, torch.as_tensor(batch["patch_embeddings"], device=x.device),
                torch.as_tensor(batch["patch_mask"], device=x.device))
        if cfg.is_enc_dec and cfg.rope_theta <= 0:
            x = x + _positions(tokens.shape[-1], x.device)[None]
        return x

    def _logits(params, x):
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return x @ head

    def _ctx(params, batch, s, device, window, shard_fn=None,
             rep_shard_fn=None):
        ctx = {"positions": torch.arange(s, device=device)[None, :],
               "shard_fn": shard_fn, "rep_shard_fn": rep_shard_fn}
        if window is not None:
            ctx["window"] = window
        if cfg.is_enc_dec:
            ctx["enc_out"] = _encode(params["enc_stack"],
                                     params["enc_final_norm"],
                                     batch["frame_embeddings"], shard_fn)
        return ctx

    # The GSPMD arguments, as the reference's signatures have them:
    # ``shard_fn`` / ``rep_shard_fn`` are `dist.sharding`'s constraint hooks
    # (identity on plain tensors), ``remat`` recomputes each super-block in
    # the backward, ``unroll`` is a no-op (the stack is a Python loop).

    def apply(params, batch, shard_fn=None, remat=False, window=None,
              unroll=False, rep_shard_fn=None):
        x, aux = _hidden(params, batch, shard_fn=shard_fn, remat=remat,
                         window=window, unroll=unroll,
                         rep_shard_fn=rep_shard_fn)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return x @ head, {"lb_loss": aux}

    def _hidden(params, batch, shard_fn=None, remat=False, window=None,
                unroll=False, rep_shard_fn=None):
        tokens = batch["tokens"]
        x = _embed_inputs(params["embed"], batch)
        x, aux = T.stack_fwd(params["stack"], x, cfg, program,
                             _ctx(params, batch, tokens.shape[1], x.device,
                                  window, shard_fn, rep_shard_fn),
                             remat=remat, unroll=unroll)
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux

    def _lb(aux):
        """The loss's load-balance term of a stack's summed aux."""
        return 0.01 * aux / max(1, repeats)

    def loss(params, batch, shard_fn=None, remat=False, unroll=False,
             rep_shard_fn=None):
        """Cross-entropy through `_chunked_ce` plus the MoE load-balance
        term (the reference's ``loss``); returns ``(ce + 0.01 · lb /
        max(1, R), {"ce", "lb_loss"})``."""
        x, aux = _hidden(params, batch, shard_fn=shard_fn, remat=remat,
                         unroll=unroll, rep_shard_fn=rep_shard_fn)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        ce = _chunked_ce(x, head, batch["labels"], batch.get("loss_mask"))
        return ce + _lb(aux), {"ce": ce, "lb_loss": aux}

    def stacked_loss(units, batch, cell_size=None):
        """Per-client losses ``[N]`` of the simulator's client-stacked
        unit list (``[{"embed"}, rep_1 .. rep_R, {"final_norm"[, "head"][,
        "enc_stack", "enc_final_norm"]}]``, every leaf ``[N, ...]``) on a
        ``[N, b, S]`` batch: client i's loss is ``loss`` of its own slice
        — the reference's vmap of ``loss`` over clients, written as one
        forward whose products run per client (`layers.mm`), whose norms
        take a grouped ``[N, d]`` scale, whose attention folds the
        clients into its batch and whose MoE blocks route each client's
        tokens on their own.  Stubs (``patch_embeddings``/``patch_mask``,
        ``frame_embeddings``) carry the client axis; a whisper batch
        without frames raises ``KeyError``, as the reference's.

        ``cell_size`` is the grid runner's N, where the client axis folds
        G cells of N clients (`utils.cells`): every op whose plan may
        follow the leading extent runs once per cell — the products, the
        embedding gather, the MoE and mamba blocks and the cross-entropy
        with its sums — and the norms are planned on one cell's rows;
        attention and the elementwise ops run once over the ``G·N``
        fold.  Each cell's losses and gradients are then its own run's."""
        s = batch["tokens"].shape[2]
        emb = units[0]["embed"]                               # [N, V, d]
        head_u = units[-1]
        x = _embed_inputs(emb, batch, cell_size)
        ctx = {"positions": torch.arange(s, device=x.device)[None, :],
               "cell_size": cell_size}
        if cfg.is_enc_dec:
            ctx["enc_out"] = _encode(_client_reps(head_u["enc_stack"]),
                                     head_u["enc_final_norm"],
                                     batch["frame_embeddings"])
        x, aux = T.stack_fwd(list(units[1:-1]), x, cfg, program, ctx)
        x = L.rmsnorm(x, head_u["final_norm"], cfg.norm_eps, cell_size)
        head = emb.transpose(1, 2) if cfg.tie_embeddings else head_u["head"]
        ce = by_cell(lambda *a: _chunked_ce(*a, per_client=True), cell_size,
                     x, head, batch["labels"], batch.get("loss_mask"))
        return ce + _lb(aux)

    def split_loss(client_stacked, server, batch, *, shard_fn=None,
                   remat=False, unroll=False, rep_shard_fn=None):
        """HASFL split-training loss (paper Sec. III-B), as the
        reference's: each client's embedding and prefix repetitions run
        per client (client-stacked ``[N, c, ...]`` leaves, one product a
        client), the server concatenates every client's activations into
        one batch of ``N·b`` sequences and runs the suffix once.  Whisper's
        encoder is the server's: it encodes ``frame_embeddings [N, b,
        Senc, d]`` once over the ``N·b`` rows, and each client's prefix
        attends to its own rows.  The tied head is the client-mean
        embedding, transposed.  Batch: tokens, labels ``[N, b, S]`` (an
        optional ``loss_mask``, and the family's stubs).  Returns ``(ce +
        0.01 · (Σ_c aux_c + aux_s) / max(1, R), {"ce"})``."""
        tokens = batch["tokens"]
        n, bsz, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :]
        enc_out = None
        if cfg.is_enc_dec:
            fe = batch["frame_embeddings"]
            enc_out = _encode(server["enc_stack"], server["enc_final_norm"],
                              fe.reshape(n * bsz, *fe.shape[2:]), shard_fn)
        x = _embed_inputs(client_stacked["embed"], batch)     # [N, b, S, d]
        # the hooks see the prefix's [N, b, S, d] activations with the
        # client axis in front: `make_shard_fn` lays it over the data axes,
        # where the batch sharding puts each client's inputs
        ctx = {"positions": positions, "shard_fn": shard_fn,
               "rep_shard_fn": rep_shard_fn}
        if enc_out is not None:
            ctx["enc_out"] = enc_out.reshape(n, bsz, *enc_out.shape[1:])
        aux_c = 0.0
        prefix = client_stacked["stack_prefix"]
        if T.n_repeats(prefix, axis=1):
            x, aux_c = T.stack_fwd(_client_reps(prefix), x, cfg, program,
                                   dict(ctx, rep_shard_fn=None),
                                   remat=remat, unroll=unroll)
        # activation hand-off: the client batches concatenated
        x = x.reshape(n * bsz, s, x.shape[-1])
        if enc_out is not None:
            ctx["enc_out"] = enc_out
        x, aux_s = T.stack_fwd(server["stack_suffix"], x, cfg, program, ctx,
                               remat=remat, unroll=unroll)
        x = L.rmsnorm(x, server["final_norm"], cfg.norm_eps)
        head = client_stacked["embed"].mean(dim=0).T if cfg.tie_embeddings \
            else server["head"]
        mask = batch.get("loss_mask")
        ce = _chunked_ce(x, head, batch["labels"].reshape(n * bsz, s),
                         None if mask is None else mask.reshape(n * bsz, s))
        return ce + _lb(_aux_total(aux_c) + aux_s), {"ce": ce}

    def init_cache(batch, cache_len, window=None, device=None):
        return T.cache_init(cfg, batch, cache_len, window, device)

    def prefill(params, batch, cache_len=None, window=None, unroll=False,
                shard_fn=None):
        """Logits of the last prompt position ``[B, 1, V]`` and the cache
        for ``cache_len`` positions (default: the prompt length).  The
        batch carries the family's stubs (``frame_embeddings``;
        ``patch_embeddings`` and ``patch_mask``) as tensors or arrays."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed_inputs(params["embed"], batch)
        ctx = _ctx(params, batch, s, x.device, window, shard_fn)
        cache = T.cache_init(cfg, b, cache_len or s, window, x.device)
        x, cache = T.stack_prefill(params["stack"], cache, x, cfg, program,
                                   ctx)
        return _logits(params, x[:, -1:].contiguous()), cache

    def decode_step(params, cache, batch, window=None, unroll=False,
                    shard_fn=None):
        """One token per sequence: ``batch["tokens"]`` [B, 1] at
        ``batch["positions"]`` [B], each sequence at its own position.  The
        cache is updated in place and returned.  Positions may lie on the
        card: nothing is read back to the host (the decode kernel masks
        each slot by its stored position on the device).  ``unroll`` and
        ``shard_fn`` are the reference's dry-run arguments (no-ops here)."""
        tokens, positions = batch["tokens"], batch["positions"]
        x = params["embed"][tokens]                 # [B, 1, d]
        dev_pos = positions.to(x.device)
        if cfg.is_enc_dec and cfg.rope_theta <= 0:
            # the reference's sinusoidal_positions(8192, d)[clip(pos, 0, 8191)]
            rows = L.SINUSOIDAL_ROWS
            table = _positions(rows, x.device)
            x = x + table[dev_pos.long().clamp(0, rows - 1)][:, None]
        ctx = {"positions": dev_pos, "shard_fn": shard_fn}
        if window is not None:
            ctx["window"] = window
        x, cache = T.stack_decode(params["stack"], cache, x, cfg, program,
                                  ctx)
        return _logits(params, x), cache

    return Model(cfg, init, apply, loss, init_cache, prefill, decode_step,
                 stacked_loss=stacked_loss, split_loss=split_loss)


# ---------------------------------------------------------------------------
# CNNs
# ---------------------------------------------------------------------------

def _build_cnn(cfg: ModelConfig) -> Model:
    def init(gen, device=None):
        return C.cnn_init(gen, cfg, device)

    def apply(params, batch, shard_fn=None, **kw):
        return C.cnn_forward_layers(params, batch["images"], cfg), {}

    def loss(params, batch, shard_fn=None, **kw):
        return C.cnn_loss(params, batch["images"], batch["labels"], cfg,
                          loss_mask=batch.get("loss_mask"))

    def stacked_loss(params, batch, cell_size=None):
        return C.cnn_stacked_loss(
            params, batch["images"], batch["labels"], cfg,
            loss_mask=batch.get("loss_mask"), cell_size=cell_size)

    def _no_cache(*a, **k):
        raise NotImplementedError("CNNs have no decode path")

    return Model(cfg, init, apply, loss, _no_cache, _no_cache, _no_cache,
                 stacked_loss=stacked_loss)
