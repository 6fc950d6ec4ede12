"""The host plane of a run, worked out again from the seed.

A frozen copy of the arithmetic the program's host side does before and
between rounds: the synthetic data sets, the client partition, the edge
device pool, the per-round gather plan and the controllers' decisions.
The draws follow the program's documented assembly order (one
``default_rng(seed)`` feeds the partition, then the device pool, then
every round's gather plan; the controller's estimate draws from its own
``default_rng(seed)``), so a sound program draws exactly these indices.
Nothing here imports the program.
"""
from __future__ import annotations

import copy
import re

import numpy as np

from simbench.reference.hasfl.bcd import HASFLOptimizer
from simbench.reference.hasfl.config import SFLConfig
from simbench.reference.hasfl.convergence import estimate_constants
from simbench.reference.hasfl.latency import sample_devices
from simbench.reference.hasfl.profiles import model_profile


# The traffic file's keys the reference models; a run with any other spec
# field (a scenario, a fault mode, a reconfiguration period, a traffic
# plane, a mesh, ...) would go unchecked, so it is refused.
MODELLED = ("n_clients", "partition", "n_train", "n_test", "seq_len",
            "policy", "estimate", "eval_every", "sfl")
PARTITIONS = ("iid", "noniid-shards")
SEQ_LEN = 32            # the spec's default, where the traffic names none


def check_traffic(traffic: dict) -> None:
    """Raise unless the reference models every key of ``traffic``."""
    extra = sorted(set(traffic) - set(MODELLED))
    if extra:
        raise NotImplementedError(
            f"the reference does not model the traffic keys {extra}")
    if traffic["partition"] not in PARTITIONS:
        raise NotImplementedError(
            f"the reference does not model partition "
            f"{traffic['partition']!r}")


def make_cifar_like(n_classes: int = 10, n_train: int = 2000,
                    n_test: int = 400, image_size: int = 32, seed: int = 0):
    """Class-template images with shifts, noise and brightness."""
    rng = np.random.default_rng(seed)
    freq = 4
    base = rng.standard_normal((n_classes, freq, freq, 3))
    templates = np.stack([
        np.kron(base[c], np.ones((image_size // freq, image_size // freq, 1)))
        for c in range(n_classes)])
    templates = templates / np.abs(templates).max()

    def sample(n):
        labels = rng.integers(0, n_classes, n)
        imgs = templates[labels].copy()
        shifts = rng.integers(-3, 4, (n, 2))
        for i in range(n):
            imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
        imgs += rng.normal(0, 0.35, imgs.shape)
        imgs *= rng.uniform(0.8, 1.2, (n, 1, 1, 1))
        return imgs.astype(np.float32), labels.astype(np.int32)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return (xtr, ytr), (xte, yte)


def make_lm_data(vocab: int = 512, n_seqs: int = 512, seq_len: int = 128,
                 seed: int = 0):
    """Token sequences from a sparse random Markov chain."""
    rng = np.random.default_rng(seed)
    n_succ = 4
    successors = rng.integers(0, vocab, (vocab, n_succ))
    seqs = np.zeros((n_seqs, seq_len + 1), np.int32)
    state = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        pick = rng.integers(0, n_succ, n_seqs)
        state = successors[state, pick]
        jump = rng.random(n_seqs) < 0.05
        state = np.where(jump, rng.integers(0, vocab, n_seqs), state)
    return seqs[:, :-1], seqs[:, 1:]


def partition_iid(n_samples: int, n_clients: int, rng) -> list:
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def partition_noniid_shards(labels, n_clients: int, rng,
                            shards_per_client: int = 2) -> list:
    """Sort by label, deal two random label-sorted shards to each client."""
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    return [np.sort(np.concatenate([shards[s] for s in
                                    perm[i * shards_per_client:
                                         (i + 1) * shards_per_client]]))
            for i in range(n_clients)]


def draw_indices(rng, pool, batch: int):
    return rng.choice(pool, size=min(batch, len(pool)),
                      replace=len(pool) < batch)


def parse_fixed(policy: str):
    """``fixed(b=B,cut=C)`` -> (B, C); None for any other policy."""
    m = re.fullmatch(r"\s*fixed\(\s*b\s*=\s*(\d+)\s*,\s*cut\s*=\s*(\d+)\s*\)\s*",
                     policy)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


class HostPlane:
    """Data, partition, devices and draws of one run (``ref`` the
    configuration's reference module, ``arch`` its architecture,
    ``traffic`` the cell's traffic dict)."""

    def __init__(self, ref, arch, traffic: dict, seed: int):
        check_traffic(traffic)
        self.ref = ref
        self.arch = arch
        self.traffic = traffic
        self.seed = int(seed)
        n, n_train = traffic["n_clients"], traffic["n_train"]
        self.train, labels = ref.train_data(arch, traffic, self.seed)
        rng = np.random.default_rng(self.seed)
        if traffic["partition"] == "iid":
            self.pools = partition_iid(n_train, n, rng)
        else:
            self.pools = partition_noniid_shards(labels, n, rng)
        self.devices = sample_devices(n, rng)
        self.rng = rng                      # every round's gather plan
        self.sfl = SFLConfig(n_devices=n, **traffic["sfl"])

    def round_draws(self, b) -> list:
        """One round's indices, client by client (each ``b_i`` long)."""
        return [np.asarray(draw_indices(self.rng, pool, int(bi)))
                for pool, bi in zip(self.pools, b)]

    def decision(self, grad_fn, units):
        """The first boundary's (b, cuts): a ``fixed(b=,cut=)`` policy's
        uniform pair, or the HASFL controller's first decision, its
        G²/σ² estimate taken with ``grad_fn(units, batch)`` (the clipped
        per-unit gradients of one model on one host batch)."""
        n = self.traffic["n_clients"]
        fixed = parse_fixed(self.traffic["policy"])
        if fixed is not None:
            return np.full(n, fixed[0]), np.full(n, fixed[1])
        if self.traffic["policy"] != "hasfl":
            raise NotImplementedError(self.traffic["policy"])
        profile = copy.deepcopy(model_profile(self.arch))
        if self.traffic.get("estimate", True):
            spans = self.ref.unit_layer_spans(self.arch, len(units),
                                              profile.n_layers)
            _blend_estimate(profile, spans, self.train, grad_fn, units,
                            np.random.default_rng(self.seed))
        d = HASFLOptimizer(profile, self.devices, self.sfl).solve(
            b0=None, cuts0=None, max_iter=4)
        return np.asarray(d.b), np.asarray(d.cuts)


def _blend_estimate(profile, spans, arrays, grad_fn, units, est_rng,
                    n_batches: int = 3, batch_size: int = 16,
                    mix: float = 0.5) -> None:
    """The controller's online G²/σ² step: per-unit gradient moments of
    the aggregated model over ``n_batches`` host batches, spread over each
    unit's layers (``spans``, the unit's ``(lo, hi)`` of the profile's) by
    parameter count, rescaled to the prior's total mass and blended into
    ``profile`` (in place)."""
    g_total = float(profile.g_sq.sum())
    s_total = float(profile.sigma_sq.sum())
    n_total = len(next(iter(arrays.values())))
    take = min(batch_size, n_total)
    samples = []
    for _ in range(n_batches):
        idx = est_rng.choice(n_total, size=take, replace=False)
        batch = {k: np.asarray(v)[idx] for k, v in arrays.items()}
        samples.append([np.concatenate([g.detach().cpu().double().numpy()
                                        .ravel() for g in leaves])
                        for leaves in grad_fn(units, batch)])
    per_unit = estimate_constants(samples)
    n_layers = profile.n_layers
    g_sq = np.zeros(n_layers)
    sigma_sq = np.zeros(n_layers)
    w = np.maximum(profile.params, 1.0)
    for u, (lo, hi) in enumerate(spans):
        share = w[lo:hi] / w[lo:hi].sum()
        g_sq[lo:hi] += per_unit["g_sq"][u] * share
        sigma_sq[lo:hi] += per_unit["sigma_sq"][u] * share
    g_new = _rescaled(g_sq, g_total)
    s_new = _rescaled(sigma_sq, s_total)
    profile.g_sq = (1 - mix) * profile.g_sq + mix * g_new
    profile.sigma_sq = (1 - mix) * profile.sigma_sq + mix * s_new


def _rescaled(est, prior_total: float):
    total = float(est.sum())
    return est if total <= 0.0 else est * (prior_total / total)
