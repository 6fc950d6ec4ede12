"""Input shapes of the serving path, as ``(shape, dtype)`` pairs.

Port of the ``prefill`` and ``decode`` kinds of `repro.configs.input_shapes`
(numpy only).  ``input_specs`` returns numpy ``(shape, dtype)`` pairs where
the reference returns ``jax.ShapeDtypeStruct``; ``concrete_inputs`` draws
the same numpy arrays from the same seed.  The train kind and the modality
stubs (audio frames, vision patches) wait for the families that need them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Data inputs for one (arch x input-shape) combination.

    prefill : tokens [B, S]
    decode  : one new token per sequence and its position (the cache is
              model state, made by the model's ``init_cache``/``prefill``).
    """
    if cfg.is_enc_dec or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.arch_id}: modality stubs are not ported (ROADMAP queue 1 "
            "item 7: enc-dec and VLM)")
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        return {"tokens": ((b, s), np.dtype(np.int32))}
    if shape.kind == "decode":
        return {"tokens": ((b, 1), np.dtype(np.int32)),
                "positions": ((b,), np.dtype(np.int32))}
    raise NotImplementedError(
        f"input kind {shape.kind!r} is not ported (token training waits for "
        "ROADMAP queue 1 item 7)")


def concrete_inputs(cfg: ModelConfig, shape: InputShape, seed: int = 0) -> dict:
    """Small *concrete* inputs of the same structure (for smoke tests)."""
    rng = np.random.default_rng(seed)
    hi = max(cfg.vocab_size, cfg.n_classes, 2)
    return {k: rng.integers(0, hi, shp).astype(dt)
            for k, (shp, dt) in input_specs(cfg, shape).items()}
