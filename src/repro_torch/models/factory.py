"""Public model API: build_model(cfg) -> Model bundle (CNN family).

Port of the CNN branch of `repro.models.factory`; the token families are
still to port (ROADMAP.md) and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.config import ModelConfig, CNN
from repro_torch.models import cnn as C


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable          # (generator, device) -> params
    apply: Callable         # (params, batch) -> (logits, aux)
    loss: Callable          # (params, batch) -> (loss, metrics)
    # per-client losses [N] over [N, ...]-stacked params/batches
    stacked_loss: Callable = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != CNN:
        raise NotImplementedError(
            f"{cfg.family!r} models are not ported yet (ROADMAP: token "
            "models); only the CNN family is")

    def init(gen, device=None):
        return C.cnn_init(gen, cfg, device)

    def apply(params, batch):
        return C.cnn_forward_layers(params, batch["images"], cfg), {}

    def loss(params, batch):
        return C.cnn_loss(params, batch["images"], batch["labels"], cfg,
                          loss_mask=batch.get("loss_mask"))

    def stacked_loss(params, batch):
        return C.cnn_stacked_loss(
            params, batch["images"], batch["labels"], cfg,
            loss_mask=batch.get("loss_mask"))

    return Model(cfg, init, apply, loss, stacked_loss=stacked_loss)
