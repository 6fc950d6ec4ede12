"""HASFL latency model — paper Eqns (28)–(40).

All times in seconds; data sizes in bits; compute in FLOPs.  The model is
exact to the paper: per-round split-training latency

    T_S(b, mu) = max_i{T_i^F + T_{a,i}^U} + T_s^F + T_s^B
                 + max_i{T_{g,i}^D + T_i^B}                      (38)

and periodic client-side aggregation latency

    T_A(b, mu) = max_i{T_{c,i}^U, T_s^U} + max_i{T_{c,i}^D, T_s^D}  (39)

with T(b, mu) = R*T_S + floor(R/I)*T_A.                           (40)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.config import DeviceProfile, SFLConfig
from repro_torch.core.profiles import LayerProfile


@dataclass
class RoundLatency:
    t_f: np.ndarray        # (28) client FP, per device
    t_a_up: np.ndarray     # (29) activation upload
    t_s_f: float           # (30) server FP
    t_s_b: float           # (31) server BP
    t_g_down: np.ndarray   # (32) activation-grad download
    t_b: np.ndarray        # (33) client BP
    t_c_up: np.ndarray     # (34) sub-model upload
    t_s_up: float          # (35) server non-common upload
    t_c_down: np.ndarray   # (36) sub-model download
    t_s_down: float        # (37) server non-common download

    @property
    def t_split(self) -> float:                                   # (38)
        return (
            float(np.max(self.t_f + self.t_a_up)) + self.t_s_f
            + self.t_s_b + float(np.max(self.t_g_down + self.t_b))
        )

    @property
    def t_agg(self) -> float:                                     # (39)
        return (
            max(float(np.max(self.t_c_up)), self.t_s_up)
            + max(float(np.max(self.t_c_down)), self.t_s_down)
        )


# Resource floors: time-varying scenario traces (repro.scenarios) can
# drive a device's bandwidth or compute to zero during an outage burst;
# dividing by the raw value would make every max_i straggler term (and
# the BCD objective) infinite/NaN.  Clamping to a tiny floor keeps the
# objective finite-but-enormous, so the optimizer steers work away from
# the dead device instead of collapsing.
BW_FLOOR = 1.0        # bit/s
FLOPS_FLOOR = 1.0     # FLOP/s


class LatencyModel:
    def __init__(
        self, profile: LayerProfile, devices: Sequence[DeviceProfile],
        sfl: SFLConfig
    ):
        self.profile = profile
        self.sfl = sfl
        self.set_devices(devices)

    def set_devices(self, devices: Sequence[DeviceProfile]) -> None:
        """Per-round profile injection point: swap the device pool in place.

        The per-device resource arrays are cached here (with the outage
        floors applied) so a scenario-driven simulation can re-inject
        profiles every round without rebuilding them per latency query.
        """
        self.devices = list(devices)
        self.n = len(self.devices)
        self._f = np.maximum(np.array([d.flops for d in self.devices]), FLOPS_FLOOR)
        self._r_up = np.maximum(np.array([d.up_bw for d in self.devices]), BW_FLOOR)
        self._r_down = np.maximum(np.array([d.down_bw for d in self.devices]), BW_FLOOR)
        self._rf_up = np.maximum(
            np.array([d.fed_up_bw for d in self.devices]), BW_FLOOR
        )
        self._rf_down = np.maximum(
            np.array([d.fed_down_bw for d in self.devices]), BW_FLOOR
        )

    # ------------------------------------------------------------------
    def round_latency(self, b: np.ndarray, cuts: np.ndarray) -> RoundLatency:
        """b: [N] ints; cuts: [N] 1-based cut layers."""
        p = self.profile
        b = np.asarray(b, float)
        j = np.asarray(cuts, int) - 1
        f = self._f
        r_up = self._r_up
        r_down = self._r_down
        rf_up = self._rf_up
        rf_down = self._rf_down

        t_f = b * p.rho[j] / f                                    # (28)
        t_a_up = b * p.psi[j] / r_up                              # (29)
        srv_fwd = float(np.sum(b * (p.rho[-1] - p.rho[j])))
        srv_bwd = float(np.sum(b * (p.bwd[-1] - p.bwd[j])))
        t_s_f = srv_fwd / self.sfl.server_flops                   # (30)
        t_s_b = srv_bwd / self.sfl.server_flops                   # (31)
        t_g_down = b * p.chi[j] / r_down                          # (32)
        t_b = b * p.bwd[j] / f                                    # (33)

        delta = p.delta[j]
        t_c_up = delta / rf_up                                    # (34)
        lam_s = self.n * float(np.max(delta)) - float(np.sum(delta))
        t_s_up = lam_s / self.sfl.server_fed_bw                   # (35)
        t_c_down = delta / rf_down                                # (36)
        t_s_down = lam_s / self.sfl.server_fed_bw                 # (37)
        return RoundLatency(
            t_f, t_a_up, t_s_f, t_s_b, t_g_down, t_b,
            t_c_up, t_s_up, t_c_down, t_s_down
        )

    def t_split(self, b, cuts) -> float:
        return self.round_latency(b, cuts).t_split

    def t_agg(self, b, cuts) -> float:
        return self.round_latency(b, cuts).t_agg

    # -- two-tier (client -> edge server -> cloud) clock (DESIGN.md §15)
    def tiered_round(self, b, cuts, n_edges: int, *,
                     edge_flops: float = 0.0,
                     edge_bw: float = 0.0) -> tuple:
        """``(t_split, t_agg)`` under the two-tier topology: edge server
        ``e`` fronts the contiguous client block ``[e*C, (e+1)*C)``.

        A designed extension of the Eq. 28-39 clock: each barrier takes
        its straggler max *per edge*, adds that edge's relay/aggregation
        terms, then maxes across edges.  ``edge_bw`` (bit/s) prices the
        edge->cloud relay — summed activation/gradient bits per edge on
        the split barriers (Eq. 29/32 traffic transits the edge), the
        largest member sub-model on the aggregation barrier (the edge
        uploads one partially-aggregated model).  ``edge_flops``
        (bit-adds/s) prices the edge's partial aggregation over its
        members' sub-model bits.  Zeros mean a co-located edge (no
        term), and ``n_edges=1`` with both zero reduces to Eq. 38/39
        *bitwise* (a single-edge max is the global max; ``x + 0.0`` is
        ``x``) — the degenerate contract `tests/test_mesh.py` gates.
        """
        n = self.n
        n_edges = int(n_edges)
        if n_edges < 1 or n % n_edges != 0:
            raise ValueError(
                f"n_edges {n_edges} must divide the cohort size {n}")
        e = n // n_edges
        rl = self.round_latency(b, cuts)
        p = self.profile
        bf = np.asarray(b, float)
        j = np.asarray(cuts, int) - 1

        def per_edge(x):
            return np.asarray(x, float).reshape(n_edges, e)

        # split barrier (Eq. 38 per tier): client->edge straggler max,
        # plus the edge's relay of its members' summed traffic
        act_bits = per_edge(bf * p.psi[j]).sum(axis=1)
        grad_bits = per_edge(bf * p.chi[j]).sum(axis=1)
        relay_up = act_bits / edge_bw if edge_bw > 0 else 0.0
        relay_down = grad_bits / edge_bw if edge_bw > 0 else 0.0
        t_split = (
            float(np.max(per_edge(rl.t_f + rl.t_a_up).max(axis=1) + relay_up))
            + rl.t_s_f + rl.t_s_b
            + float(np.max(relay_down
                           + per_edge(rl.t_g_down + rl.t_b).max(axis=1)))
        )

        # aggregation barrier (Eq. 39 per tier): members upload to the
        # edge, the edge partially aggregates (summing its members'
        # sub-model bits) and relays one partial model up; the download
        # mirrors the relay
        dsum = per_edge(p.delta[j]).sum(axis=1)
        dmax = per_edge(p.delta[j]).max(axis=1)
        agg_cmp = dsum / edge_flops if edge_flops > 0 else 0.0
        model_relay = dmax / edge_bw if edge_bw > 0 else 0.0
        t_agg = (
            max(float(np.max(per_edge(rl.t_c_up).max(axis=1)
                             + agg_cmp + model_relay)), rl.t_s_up)
            + max(float(np.max(model_relay
                               + per_edge(rl.t_c_down).max(axis=1))),
                  rl.t_s_down)
        )
        return t_split, t_agg

    # -- fault-aware round accounting (DESIGN.md §12) -------------------
    def _server_terms(self, b, cuts, m: np.ndarray):
        """Eq. 30/31 restricted to the participating subset ``m``: the
        server only runs forward/backward for activations that actually
        arrived."""
        p = self.profile
        b = np.asarray(b, float)
        j = np.asarray(cuts, int) - 1
        srv_fwd = float(np.sum((b * (p.rho[-1] - p.rho[j]))[m]))
        srv_bwd = float(np.sum((b * (p.bwd[-1] - p.bwd[j]))[m]))
        return srv_fwd / self.sfl.server_flops, srv_bwd / self.sfl.server_flops

    def masked_round(self, b, cuts, part) -> tuple:
        """(t_split, t_agg) over the participating subset only.

        ``fault_mode="dropout"`` accounting: offline clients are known at
        round start (the availability mask), so neither straggler max
        (Eq. 38) nor the Eq. 39 aggregation terms wait for them, and the
        server compute sums survivors only.  An all-dropped round is a
        no-op and contributes zero time.
        """
        m = np.asarray(part, bool)
        if not m.any():
            return 0.0, 0.0
        rl = self.round_latency(b, cuts)
        t_s_f, t_s_b = self._server_terms(b, cuts, m)
        t_split = (
            float(np.max((rl.t_f + rl.t_a_up)[m])) + t_s_f + t_s_b
            + float(np.max((rl.t_g_down + rl.t_b)[m]))
        )
        cnt = int(m.sum())
        p = self.profile
        delta = p.delta[np.asarray(cuts, int) - 1]
        lam_s = cnt * float(np.max(delta[m])) - float(np.sum(delta[m]))
        t_s_up = lam_s / self.sfl.server_fed_bw
        t_agg = (
            max(float(np.max(rl.t_c_up[m])), t_s_up)
            + max(float(np.max(rl.t_c_down[m])), t_s_up)
        )
        return t_split, t_agg

    def deadline_round(self, b, cuts, avail, factor: float) -> tuple:
        """(participation mask, t_split, t_agg) under per-phase deadlines.

        ``fault_mode="deadline"`` accounting: each Eq. 38 barrier gets a
        deadline of ``factor x`` the available cohort's median phase
        latency.  Clients missing a deadline are dropped from the round;
        the barrier clock advances at the deadline (the server cannot
        observe a miss earlier), not at the straggler max — so a
        floored-resource outage costs at most ``factor x`` median
        instead of the enormous soft-degradation max.  Offline clients
        never participate (and never extend a barrier beyond its
        deadline); with every client offline the round is a timeless
        no-op, like `masked_round`.
        """
        m0 = np.asarray(avail, bool)
        if not m0.any():
            return np.zeros(self.n, bool), 0.0, 0.0
        rl = self.round_latency(b, cuts)
        up = rl.t_f + rl.t_a_up
        down = rl.t_g_down + rl.t_b
        d_up = factor * float(np.median(up[m0]))
        d_down = factor * float(np.median(down[m0]))
        m1 = m0 & (up <= d_up)
        part = m1 & (down <= d_down)
        t_up = min(float(np.max(up[m0])), d_up)
        # phase 2 runs only for clients whose activations arrived (m1)
        t_s_f, t_s_b = self._server_terms(b, cuts, m1)
        t_down = min(float(np.max(down[m1])), d_down) if m1.any() else 0.0
        t_split = t_up + t_s_f + t_s_b + t_down
        if part.any():
            _, t_agg = self.masked_round(b, cuts, part)
        else:
            t_agg = 0.0
        return part, t_split, t_agg

    def per_client_round(self, b, cuts) -> np.ndarray:
        """[N] *unbarriered* per-client round durations (traffic plane).

        The semi-async mode has no Eq. 38 straggler max: each client's
        update arrives when *that client* finishes, so its duration is
        its own forward + activation upload + its share of the server
        compute (Eq. 30/31 restricted to its own activations — the
        server pipelines clients independently in this mode) + gradient
        download + backward.  The Eq. 39 aggregation exchange is not
        charged here; the plane's server closes rounds on deliveries,
        not barriers (DESIGN.md §14).
        """
        p = self.profile
        b = np.asarray(b, float)
        j = np.asarray(cuts, int) - 1
        rl = self.round_latency(b, cuts)
        srv = b * ((p.rho[-1] - p.rho[j]) + (p.bwd[-1] - p.bwd[j])) \
            / self.sfl.server_flops
        return rl.t_f + rl.t_a_up + srv + rl.t_g_down + rl.t_b

    def total(self, b, cuts, rounds: int) -> float:               # (40)
        rl = self.round_latency(b, cuts)
        return rounds * rl.t_split + (rounds // self.sfl.agg_interval) * rl.t_agg

    def per_round_effective(self, b, cuts) -> float:
        """T_S + T_A / I — the numerator of the BCD objective."""
        rl = self.round_latency(b, cuts)
        return rl.t_split + rl.t_agg / self.sfl.agg_interval

    # ------------------------------------------------------------------
    def memory_bits(self, b: np.ndarray, cuts: np.ndarray) -> np.ndarray:
        """Constraint C4 left-hand side per device."""
        p = self.profile
        j = np.asarray(cuts, int) - 1
        psi_cum = np.cumsum(p.psi)
        chi_cum = np.cumsum(p.chi)
        opt_state = p.delta * self.sfl.optimizer_state_mult
        return (
            np.asarray(b, float) * (psi_cum[j] + chi_cum[j])
            + opt_state[j] + p.delta[j]
        )

    def feasible(self, b, cuts) -> bool:
        mem = np.array([d.memory for d in self.devices])
        return bool(np.all(self.memory_bits(b, cuts) < mem))


def sample_devices(
    n: int, rng: np.random.Generator, *,
    flops_range=(1e12, 2e12),
    up_range=(75e6, 80e6),
    down_range=(360e6, 380e6),
    memory_bits: float = 8 * 4e9
) -> list:
    """Paper Table I heterogeneous device pool."""
    devs = []
    for _ in range(n):
        devs.append(
            DeviceProfile(
                flops=float(rng.uniform(*flops_range)),
                up_bw=float(rng.uniform(*up_range)),
                down_bw=float(rng.uniform(*down_range)),
                fed_up_bw=float(rng.uniform(*up_range)),
                fed_down_bw=float(rng.uniform(*down_range)),
                memory=memory_bits,
            )
        )
    return devs
