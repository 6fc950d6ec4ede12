"""Input shapes of the training and serving paths, as ``(shape, dtype)``
pairs.

Port of `repro.configs.input_shapes` (numpy only), with the modality
stubs: precomputed audio frame embeddings (enc-dec; train and prefill)
and vision patch embeddings with their mask (VLM; train and prefill).  ``input_specs`` returns numpy ``(shape, dtype)`` pairs
where the reference returns ``jax.ShapeDtypeStruct``; ``concrete_inputs``
draws the same numpy arrays from the same seed, in the same key order.
numpy has no bf16, so an embedding stub of a bf16 model is an fp32 array
holding the bf16 values (the reference's draws rounded to bf16 as it
rounds them, through fp32): bitwise the reference's once widened to fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

_STUB_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Data inputs for one (arch x input-shape) combination.

    train   : tokens and labels [B, S] (+ stubs); a CNN's images and labels
    prefill : tokens [B, S] (+ stubs)
    decode  : one new token per sequence and its position (the cache is
              model state, made by the model's ``init_cache``/``prefill``;
              the encoder ran at prefill, so decode takes no stub).
    Embedding stubs are fp32 specs holding values of ``cfg.dtype``.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = np.dtype(np.int32)
    f32 = np.dtype(np.float32)
    if shape.kind == "train":
        if cfg.is_cnn:
            return {"images": ((b, cfg.image_size, cfg.image_size, 3), f32),
                    "labels": ((b,), i32)}
        specs = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": ((b, s), i32)}
    else:
        return {"tokens": ((b, 1), i32), "positions": ((b,), i32)}
    if cfg.is_enc_dec:
        # precomputed audio frame embeddings (mel+conv stub output)
        specs["frame_embeddings"] = ((b, cfg.encoder_seq, cfg.d_model), f32)
    if cfg.n_patches:
        specs["patch_embeddings"] = ((b, cfg.n_patches, cfg.d_model), f32)
        # which positions take patch embeddings
        specs["patch_mask"] = ((b, s), np.dtype(np.bool_))
    return specs


def concrete_inputs(cfg: ModelConfig, shape: InputShape, seed: int = 0) -> dict:
    """Small *concrete* inputs of the same structure (for smoke tests)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in input_specs(cfg, shape).items():
        if np.issubdtype(dt, np.integer):
            hi = max(cfg.vocab_size, cfg.n_classes, 2)
            out[k] = rng.integers(0, hi, shp).astype(dt)
        elif dt == np.bool_:
            arr = np.zeros(shp, np.bool_)
            arr[..., : min(8, shp[-1])] = True
            out[k] = arr
        else:
            draws = torch.from_numpy(rng.standard_normal(shp).astype(dt))
            out[k] = draws.to(_STUB_DTYPES[cfg.dtype]).float().numpy()
    return out
