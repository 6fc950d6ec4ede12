"""Public model API: build_model(cfg) -> Model bundle.

Port of `repro.models.factory` for the CNN family (the simulator's
models) and the token families the port serves (DENSE, SSM): ``init``,
``apply``, ``init_cache``, ``prefill`` and ``decode_step``.  The token
models' ``loss``/``split_loss`` wait for the training slice, and the
MOE/HYBRID/AUDIO/VLM families raise (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.config import ModelConfig, CNN
from repro_torch.models import cnn as C
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


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
        """Parameters ``{"embed", "stack", "final_norm"[, "head"]}`` drawn
        from ``gen`` (on the generator's device, then moved to
        ``device``)."""
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
        return params

    def _logits(params, x):
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return x @ head

    def _ctx(s, device, window):
        ctx = {"positions": torch.arange(s, device=device)[None, :]}
        if window is not None:
            ctx["window"] = window
        return ctx

    def apply(params, batch, window=None):
        tokens = batch["tokens"]
        x = params["embed"][tokens]
        x = T.stack_fwd(params["stack"], x, cfg, program,
                        _ctx(tokens.shape[1], x.device, window))
        return _logits(params, x), {}

    def loss(params, batch):
        raise NotImplementedError(
            "token-model training is not ported yet (ROADMAP queue 1 item 7: "
            "loss, split_loss and the SPMD step)")

    def init_cache(batch, cache_len, window=None, device=None):
        return T.cache_init(cfg, batch, cache_len, window, device)

    def prefill(params, batch, cache_len=None, window=None):
        """Logits of the last prompt position ``[B, 1, V]`` and the cache
        for ``cache_len`` positions (default: the prompt length)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = params["embed"][tokens]
        cache = T.cache_init(cfg, b, cache_len or s, window, x.device)
        x, cache = T.stack_prefill(params["stack"], cache, x, cfg, program,
                                   _ctx(s, x.device, window))
        return _logits(params, x[:, -1:].contiguous()), cache

    def decode_step(params, cache, batch, window=None):
        """One token per sequence: ``batch["tokens"]`` [B, 1] at
        ``batch["positions"]`` [B].  The cache is updated in place and
        returned.  Positions are best passed as a CPU tensor: the card's
        decode attention needs them on the host (one position for the
        whole batch), and a CUDA tensor costs a device sync to read."""
        tokens, positions = batch["tokens"], batch["positions"]
        x = params["embed"][tokens]                 # [B, 1, d]
        host = positions.cpu()
        ctx = {"positions": positions.to(x.device),
               "kv_len": int(host[0]) + 1 if bool((host == host[0]).all())
               else None}
        if window is not None:
            ctx["window"] = window
        x, cache = T.stack_decode(params["stack"], cache, x, cfg, program,
                                  ctx)
        return _logits(params, x), cache

    return Model(cfg, init, apply, loss, init_cache, prefill, decode_step)


# ---------------------------------------------------------------------------
# CNNs
# ---------------------------------------------------------------------------

def _build_cnn(cfg: ModelConfig) -> Model:
    def init(gen, device=None):
        return C.cnn_init(gen, cfg, device)

    def apply(params, batch):
        return C.cnn_forward_layers(params, batch["images"], cfg), {}

    def loss(params, batch):
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
