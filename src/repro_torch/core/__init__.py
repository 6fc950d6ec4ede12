"""The paper's primary contribution: HASFL split-federated-learning core.

- profiles/latency: Eqns 28-40 cost model
- convergence: Theorem 1 / Corollary 1
- bs_opt / ms_opt / bcd: the joint BS+MS optimizer (Prop. 1, Dinkelbach, Alg. 2)
- split / sfl: model partitioning + the edge simulator
"""
from repro_torch.core.profiles import model_profile, LayerProfile  # noqa: F401
from repro_torch.core.latency import LatencyModel  # noqa: F401
from repro_torch.core.convergence import ConvergenceModel  # noqa: F401
