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

from .config import DeviceProfile, SFLConfig
from .profiles import LayerProfile


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

    def per_round_effective(self, b, cuts) -> float:
        """T_S + T_A / I — the numerator of the BCD objective."""
        rl = self.round_latency(b, cuts)
        return rl.t_split + rl.t_agg / self.sfl.agg_interval

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
