"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch.  Port of
`repro.models.moe`.

Dispatch is cumsum + scatter (GShard/t5x style), as in the reference:
each (token, k) pair takes the next slot of its expert's ``capacity``
rows, in flat ``[T·K]`` order; pairs past the capacity go to a sink row
and are dropped.  The experts' SwiGLU is three batched matmuls over the
``[E, C, d]`` buffer (``torch.bmm``; the reference leaves it to XLA, no
Pallas kernel).  Expert weights are stacked ``[E, ...]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, silu, stacked_normal_init

F32 = torch.float32
MOE_TOKEN_CHUNK = 65536

# When a list, each MoE block of the models appends its `moe_ffn` aux
# dict (0-d device tensors, no host sync): how a caller reads the router's
# dropped share per forward.  None (the default) skips the aux math.
RECORD = None


def moe_init(gen, d: int, d_ff: int, n_experts: int, dtype, device=None,
             lead=()) -> dict:
    """Router (fp32) and ``[*lead, E, ...]`` expert weights, the experts
    drawn one ``[in, out]`` matrix at a time into the ``dtype`` leaf."""
    def experts(i, o):
        return stacked_normal_init(gen, (*lead, n_experts, i, o),
                                   1.0 / math.sqrt(i), dtype, device)

    return {
        "w_router": dense_init(gen, d, n_experts, F32, device, lead),
        "w_gate": experts(d, d_ff),
        "w_up": experts(d, d_ff),
        "w_down": experts(d_ff, d),
    }


def moe_ffn(params: dict, x, *, top_k: int, capacity_factor: float = 1.25,
            return_aux: bool = True):
    """x: [..., T, d] flattened internally to [T, d].

    Token streams longer than MOE_TOKEN_CHUNK (and a multiple of it) are
    processed chunk by chunk, as the reference's scan over chunks: the
    dispatch buffers scale with the chunk, not the whole stream.

    Returns (out, aux) with the Switch load-balance loss, the router
    entropy and the dropped share, as the reference, and the chosen
    experts ``expert_idx`` [T, K] (aux is ``{}`` when not ``return_aux``).
    """
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    if t > MOE_TOKEN_CHUNK and t % MOE_TOKEN_CHUNK == 0:
        n_chunks = t // MOE_TOKEN_CHUNK
        outs, auxs = [], []
        for xc in xt.split(MOE_TOKEN_CHUNK):
            out, aux = _moe_ffn_dense(params, xc, top_k=top_k,
                                      capacity_factor=capacity_factor,
                                      return_aux=return_aux)
            outs.append(out)
            auxs.append(aux)
        aux = {"lb_loss": sum(a["lb_loss"] for a in auxs) / n_chunks,
               "router_entropy": 0.0, "dropped_frac": 0.0,
               "expert_idx": torch.cat([a["expert_idx"] for a in auxs])
               } if return_aux else {}
        return torch.cat(outs).reshape(orig_shape), aux
    out, aux = _moe_ffn_dense(params, xt, top_k=top_k,
                              capacity_factor=capacity_factor,
                              return_aux=return_aux)
    return out.reshape(orig_shape), aux


def top_k_lower_first(probs, k: int):
    """The ``k`` largest of the last axis, descending, a tie taking the
    lower index first, as ``jax.lax.top_k``.  ``torch.topk`` promises no
    order among equal values, so this is a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_ffn_dense(params: dict, xt, *, top_k: int,
                   capacity_factor: float = 1.25, return_aux: bool = True):
    t, d = xt.shape
    n_experts = params["w_router"].shape[-1]
    capacity = int(max(top_k, np.ceil(t * top_k / n_experts
                                      * capacity_factor)))

    logits = xt.float() @ params["w_router"]                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_lower_first(probs, top_k)        # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- dispatch: position of each (token, k) within its expert ---------
    flat_expert = expert_idx.reshape(-1)                           # [T*K]
    onehot = F.one_hot(flat_expert, n_experts)
    pos_in_expert = onehot.cumsum(dim=0) - 1                       # [T*K, E]
    pos = pos_in_expert.gather(1, flat_expert[:, None])[:, 0]
    keep = pos < capacity                                          # drop overflow
    dest = torch.where(keep, flat_expert * capacity + pos,
                       n_experts * capacity)

    buf = torch.zeros((n_experts * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[dest] = xt.repeat_interleave(top_k, dim=0)                 # scatter
    buf = buf[:-1].reshape(n_experts, capacity, d)                 # [E, C, d]

    # ---- expert compute (SwiGLU per expert) -------------------------------
    g = silu(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    h = torch.bmm(g * u, params["w_down"])                         # [E, C, d]

    # ---- combine: gather back, weight by gate (stream dtype), sum over k --
    h_flat = torch.cat([h.reshape(-1, d), h.new_zeros((1, d))])
    out_k = h_flat[dest]                                           # [T*K, d]
    out_k = out_k * (gate_vals.reshape(-1) * keep)[:, None].to(out_k.dtype)
    out = out_k.reshape(t, top_k, d).sum(dim=1)
    if not return_aux:
        return out, {}

    # Switch load-balance loss: E * sum_e fraction_tokens_e * mean_prob_e
    frac = F.one_hot(expert_idx[:, 0], n_experts).float().mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = {
        "lb_loss": n_experts * (frac * mean_prob).sum(),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
        "expert_idx": expert_idx,
    }
    return out, aux
