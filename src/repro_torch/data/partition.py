"""Client data partitioning — IID and the paper's non-IID 2-shards scheme."""
from __future__ import annotations

import numpy as np


def partition_iid(n_samples: int, n_clients: int,
                  rng: np.random.Generator) -> list:
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def partition_noniid_shards(labels: np.ndarray, n_clients: int,
                            rng: np.random.Generator,
                            shards_per_client: int = 2) -> list:
    """Sort by label, slice into n_clients*shards_per_client shards, deal
    shards_per_client random shards to each client (paper Sec. VII-A)."""
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    out = []
    for i in range(n_clients):
        take = perm[i * shards_per_client:(i + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in take])))
    return out
