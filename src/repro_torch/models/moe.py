"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch.  Port of
`repro.models.moe`.

Dispatch is cumsum + scatter (GShard/t5x style), as in the reference:
each (token, k) pair takes the next slot of its expert's ``capacity``
rows, in flat ``[T·K]`` order; pairs past the capacity go to a sink row
and are dropped.  The experts' SwiGLU is three batched matmuls over the
``[E, C, d]`` buffer (``torch.bmm``; the reference leaves it to XLA, no
Pallas kernel).  Expert weights are stacked ``[E, ...]``, or ``[N, E,
...]`` on the simulator's and the SPMD step's client-stacked weights,
where the (client, expert) pairs fold into one ``[N·E, C, d]`` buffer.

Training differentiates the dispatch as written: the scatter's backward
gathers the buffer's gradient back to each kept (token, k) pair (a
dropped pair's sink row gets none), the combine's gather accumulates
into the experts' outputs, and the router takes its gradient from the
gates and the load-balance loss.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, mm, silu,
                                      stacked_normal_init)
from repro_torch.utils.cells import apart, cell_parts

F32 = torch.float32
MOE_TOKEN_CHUNK = 65536

# When a list, each MoE block of the models appends its `moe_ffn` aux
# dict (device tensors, no host sync; ``[N]`` entries on client-stacked
# weights): how a caller reads the router's dropped share per forward.
# None (the default) lets serving's prefill and decode skip the aux math.
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
            return_aux: bool = True, cell_size=None):
    """x: [..., T, d] flattened internally to [T, d].  With client-stacked
    weights (router ``[N, d, E]``, experts ``[N, E, ...]``) x is ``[N, ...,
    d]`` and each client's tokens go on their own, as the reference's vmap
    of the model over clients: its own routing, capacity, slot numbering,
    drops, load-balance loss and chunks (the aux entries then carry the
    client axis).

    Token streams longer than MOE_TOKEN_CHUNK (and a multiple of it) are
    processed chunk by chunk, as the reference's scan over chunks: the
    dispatch buffers scale with the chunk, not the whole stream.

    Returns (out, aux) with the Switch load-balance loss, the router
    entropy and the dropped share, as the reference, and the chosen
    experts ``expert_idx`` [..., T, K] (aux is ``{}`` when not
    ``return_aux``).

    ``cell_size`` (a grid's N, where the client axis folds G cells of N
    clients) runs the block once per cell: its products, softmax,
    dispatch sums and load-balance means may each plan by the leading
    extent.
    """
    if apart(x, cell_size):
        cells = cell_parts(params, cell_size, x.shape[0] // cell_size)
        outs, auxs = zip(*(moe_ffn(p, xc, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   return_aux=return_aux)
                           for p, xc in zip(cells, x.split(cell_size))))
        aux = {k: torch.cat([a[k] for a in auxs]) if torch.is_tensor(v)
               else v for k, v in auxs[0].items()}
        return torch.cat(outs), aux
    orig_shape = x.shape
    d = x.shape[-1]
    lead = (x.shape[0],) if params["w_router"].dim() == 3 else ()
    xt = x.reshape(*lead, -1, d)
    t = xt.shape[-2]
    if t > MOE_TOKEN_CHUNK and t % MOE_TOKEN_CHUNK == 0:
        n_chunks = t // MOE_TOKEN_CHUNK
        outs, auxs = [], []
        for xc in xt.split(MOE_TOKEN_CHUNK, dim=-2):
            out, aux = _moe_ffn_dense(params, xc, top_k=top_k,
                                      capacity_factor=capacity_factor,
                                      return_aux=return_aux)
            outs.append(out)
            auxs.append(aux)
        aux = {"lb_loss": sum(a["lb_loss"] for a in auxs) / n_chunks,
               "router_entropy": 0.0, "dropped_frac": 0.0,
               "expert_idx": torch.cat([a["expert_idx"] for a in auxs],
                                       dim=-2)
               } if return_aux else {}
        return torch.cat(outs, dim=-2).reshape(orig_shape), aux
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
    """One stream ``xt [T, d]``, or ``[N, T, d]``: N clients' streams on
    their client-stacked weights.  The (client, expert) pairs fold into
    one ``torch.bmm`` batch of ``N·E``, each client's slots at its own
    offset of the dispatch buffer: nothing loops over clients."""
    *lead, t, d = xt.shape
    n = lead[0] if lead else 1
    n_experts = params["w_router"].shape[-1]
    capacity = int(max(top_k, np.ceil(t * top_k / n_experts
                                      * capacity_factor)))

    logits = mm(xt.float(), params["w_router"])                  # [.., T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_lower_first(probs, top_k)      # [.., T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- dispatch: position of each (token, k) within its expert ---------
    flat_expert = expert_idx.reshape(n, -1)                      # [N, T*K]
    onehot = F.one_hot(flat_expert, n_experts)
    pos_in_expert = onehot.cumsum(dim=1) - 1                     # [N, T*K, E]
    pos = pos_in_expert.gather(2, flat_expert[..., None])[..., 0]
    keep = pos < capacity                                        # drop overflow
    slots = n_experts * capacity
    base = torch.arange(n, device=xt.device)[:, None] * slots
    dest = torch.where(keep, base + flat_expert * capacity + pos,
                       n * slots).reshape(-1)

    buf = torch.zeros((n * slots + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt.reshape(n, t, d).repeat_interleave(
        top_k, dim=1).reshape(-1, d)                             # scatter
    buf = buf[:-1].reshape(n * n_experts, capacity, d)           # [N·E, C, d]

    # ---- expert compute (SwiGLU per (client, expert)) ---------------------
    def experts(w):
        return w.reshape(-1, *w.shape[-2:])

    g = silu(torch.bmm(buf, experts(params["w_gate"])))
    u = torch.bmm(buf, experts(params["w_up"]))
    h = torch.bmm(g * u, experts(params["w_down"]))              # [N·E, C, d]

    # ---- combine: gather back, weight by gate (stream dtype), sum over k --
    h_flat = torch.cat([h.reshape(-1, d), h.new_zeros((1, d))])
    out_k = h_flat[dest]                                         # [N·T·K, d]
    out_k = out_k * (gate_vals.reshape(-1) * keep.reshape(-1))[:, None].to(
        out_k.dtype)
    out = out_k.reshape(*lead, t, top_k, d).sum(dim=-2)
    if not return_aux:
        return out, {}

    # Switch load-balance loss: E * sum_e fraction_tokens_e * mean_prob_e
    frac = F.one_hot(expert_idx[..., 0], n_experts).float().mean(dim=-2)
    mean_prob = probs.mean(dim=-2)
    aux = {
        "lb_loss": n_experts * (frac * mean_prob).sum(-1),
        "router_entropy": -(probs * torch.log(probs + 1e-9)).sum(-1).mean(-1),
        "dropped_frac": 1.0 - keep.float().mean(-1).reshape(lead),
        "expert_idx": expert_idx,
    }
    return out, aux
