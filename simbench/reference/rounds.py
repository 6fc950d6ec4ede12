"""The first rounds of a run, worked out by the plain reference.

Given the cell's architecture and traffic, the seed and the initial units
the benchmark made, `first_rounds` redoes what the simulator's first
rounds must do: the first boundary's decision (`host.HostPlane`), each
round's draws, every client's loss and gradient on its own batch (the
configuration's reference module ``ref``, `contract`), the per-client
clip to global norm ``clip_norm``,
and the HASFL update: per-client SGD on every unit, then the client mean
(Eq. 4) on server-common units every round and on client-specific units
every ``agg_interval`` rounds (Eq. 7).  The client-specific units are
those the decision's cuts keep on the clients (``ref.client_specific``).

``variant`` puts something other than the reference in the program's
place: ``"tf32"`` (fp32 products on the tensor cores' TF32; off the card,
their operands rounded to TF32), ``"fp8"``
(every product's operands rounded to fp8 e4m3, scaled per tensor),
``"half"`` (each client's step on the first half of its batch),
``"label"`` (the labels of one sample of each client's batch altered:
an image's class, or every next-token label of a sequence) or
``"no_eq7"`` (the every-I aggregation of the client-specific units left
out).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from simbench.reference.host import HostPlane
from simbench.reference.params import leaves

EARLY = 3               # the rounds whose losses and change are compared
VARIANTS = (None, "tf32", "fp8", "half", "label", "no_eq7")


def tf32_round(t):
    """fp32 ``t`` rounded to TF32's 10-bit mantissa (straight through for
    the gradient): the TF32 control where no tensor core runs it."""
    if t.dtype != torch.float32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


def fp8_round(t):
    """``t`` rounded to fp8 e4m3 at a per-tensor scale (straight through
    for the gradient)."""
    if not t.is_floating_point():
        return t
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / 448.0
    r = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (r.to(t.dtype) - t).detach()


@contextlib.contextmanager
def precision(variant):
    """fp32 products in full fp32, or in TF32 for the ``"tf32"`` control."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tf32 = variant == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def _batch(host, idx, device, variant, classes: int):
    out = {k: torch.as_tensor(np.asarray(v)[idx]).to(device)
           for k, v in host.train.items()}
    if variant == "half":
        keep = max(1, -(-len(idx) // 2))
        out = {k: v[:keep] for k, v in out.items()}
    if variant == "label":
        lab = out["labels"].clone()
        lab[0] = (lab[0] + 1) % classes
        out["labels"] = lab
    return out


def _grads(model_loss, units, batch, clip: float):
    """(loss, per-unit leaf gradients, clip scale) of one client."""
    ws = [[p.detach().clone().requires_grad_() for p in leaves(u)]
          for u in units]
    tree = [_rebuild(u, w) for u, w in zip(units, ws)]
    loss = model_loss(tree, batch)
    loss.backward()
    grads = [[p.grad for p in w] for w in ws]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for gs in grads for g in gs))
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0) \
        if clip else torch.ones((), device=norm.device)
    return loss.detach(), grads, scale


def _rebuild(unit, new_leaves):
    """``unit`` with its leaves (sorted-key order) replaced."""
    it = iter(new_leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(unit)


def first_rounds(ref, arch, traffic: dict, seed: int, units0: list, device,
                 rounds=None, variant=None, host=None) -> dict:
    """The reference's readings of rounds 1..``rounds`` (by default
    ``agg_interval``, the last the first Eq. 7 round): the decision, the
    draws, the losses ``[R, N]``, and per stacked leaf the norm of the
    first gradient as the update took it, ``‖p0 − p1‖ / lr``, of the
    change after the early rounds (`cell.early_rounds`), ``‖p_E − p0‖``,
    and of the change after the last round, ``‖p_R − p0‖`` (fp64, over
    all clients).  ``host`` reuses a `HostPlane` built for this seed."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    host = host or HostPlane(ref, arch, traffic, seed)
    rng_state = host.rng.bit_generator.state
    quant = fp8_round if variant == "fp8" else None
    if variant == "tf32" and torch.device(device).type != "cuda":
        quant = tf32_round
    sfl = host.sfl
    n = traffic["n_clients"]
    rounds = sfl.agg_interval if rounds is None else int(rounds)
    early = min(EARLY, rounds)

    def model_loss(tree, batch):
        return ref.loss(tree, batch, arch, quant)

    def estimate_grads(units, batch):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        _, grads, scale = _grads(model_loss, units, b, sfl.clip_norm)
        return [[(g * scale).to(g.dtype) for g in gs] for gs in grads]

    try:
        with precision(variant):
            b, cuts = host.decision(estimate_grads, units0)
            client_specific = ref.client_specific(arch, cuts, len(units0))
            classes = ref.n_labels(arch)
            p0 = [[x.detach() for x in leaves(u)] for u in units0]
            params = [[list(u) for u in p0] for _ in range(n)]
            out = {"b": np.asarray(b), "cuts": np.asarray(cuts),
                   "draws": [], "losses": []}
            for r in range(1, rounds + 1):
                draws = host.round_draws(b)
                out["draws"].append(draws)
                losses, grads, scales = [], [], []
                for i in range(n):
                    tree = [_rebuild(u, w) for u, w in zip(units0, params[i])]
                    loss, g, s = _grads(
                        model_loss, tree,
                        _batch(host, draws[i], device, variant, classes),
                        sfl.clip_norm)
                    losses.append(float(loss))
                    grads.append(g)
                    scales.append(s)
                out["losses"].append(losses)
                do_agg = r % sfl.agg_interval == 0 and variant != "no_eq7"
                params = _update(params, grads, scales, client_specific,
                                 do_agg, sfl.lr)
                if r == 1:
                    out["grad1"] = _stack_norms(p0, params, 1 / sfl.lr)
                if r == early:
                    out["delta"] = _stack_norms(p0, params, 1.0)
            out["agg_delta"] = _stack_norms(p0, params, 1.0)
    finally:
        host.rng.bit_generator.state = rng_state
    out["losses"] = np.asarray(out["losses"])
    return out


def _update(params, grads, scales, client_specific, do_agg, lr):
    """Per-client SGD on every leaf, ``p - lr·(g·s)`` in fp32, then the
    client mean of those fp32 results where the unit is server-common or
    the round aggregates; each result is rounded once, to its leaf's type
    (a bf16 leaf is stored in bf16 and updated in fp32)."""
    n = len(params)
    new = [[[None] * len(u) for u in params[0]] for _ in range(n)]
    for u, cs in enumerate(client_specific):
        for j in range(len(params[0][u])):
            dtype = params[0][u][j].dtype
            spec = [params[i][u][j].float()
                    - lr * (grads[i][u][j].float() * scales[i])
                    for i in range(n)]
            if cs and not do_agg:
                for i in range(n):
                    new[i][u][j] = spec[i].to(dtype)
            else:
                mean = (sum(spec[1:], spec[0]) / n).to(dtype)
                for i in range(n):
                    new[i][u][j] = mean
    return new


def _stack_norms(p0, params, factor: float) -> np.ndarray:
    """Per leaf, ``factor · ‖p0 − p_i‖`` over all clients i, in fp64."""
    out = []
    for u, unit in enumerate(p0):
        for j, a in enumerate(unit):
            sq = sum(float(torch.sum(torch.square(
                a.double() - client[u][j].double()))) for client in params)
            out.append(factor * math.sqrt(sq))
    return np.asarray(out)
