"""FL data partitioners: IID and Dirichlet label skew (paper Section 5.6;
a copy of ``repro.data.partition``), and the padded client stacking of the
vectorised engine."""
from __future__ import annotations

import numpy as np
import torch


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


def stack_shards(pool, client_indices):
    """Stack per-client shards of ``pool`` on a leading client axis
    (``repro.data.partition.stack_shards``).

    pool: a tensor with a leading sample axis; client_indices: N
    per-client index arrays (ragged). Returns ``(stacked, lengths)``:
    ``stacked`` is ``(N, n_max, ...)`` and ``lengths`` the ``(N,)`` true
    shard sizes (numpy). Ragged shards are
    padded with wrapped-around copies of their own samples, so padded rows
    are always valid data; the engine's step validity mask, not the
    padding, preserves the training semantics."""
    lengths = np.asarray([len(ix) for ix in client_indices], np.int64)
    if lengths.min() < 1:
        raise ValueError("every client shard must be non-empty")
    n_max = int(lengths.max())
    padded = np.stack([
        np.pad(np.asarray(ix, np.int64), (0, n_max - len(ix)), mode="wrap")
        for ix in client_indices])
    return pool[torch.from_numpy(padded).to(pool.device)], lengths
