"""FL data partitioners: IID and Dirichlet label skew (paper Section 5.6;
a copy of ``repro.data.partition``, which is numpy only)."""
from __future__ import annotations

import numpy as np


def iid_partition(n_samples: int, n_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def dirichlet_partition(labels, n_clients: int, beta: float, seed: int = 0,
                        min_per_client: int = 1):
    """For each class draw p ~ Dir(beta 1_N) and split that class's samples
    across the clients in those proportions (Hsu et al.)."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    shards = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        idx = rng.permutation(np.where(labels == c)[0])
        p = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            shards[i].extend(part.tolist())
    # guarantee non-empty clients (move from the largest shard)
    for i in range(n_clients):
        while len(shards[i]) < min_per_client:
            j = int(np.argmax([len(s) for s in shards]))
            shards[i].append(shards[j].pop())
    return [np.sort(np.array(s, dtype=np.int64)) for s in shards]
