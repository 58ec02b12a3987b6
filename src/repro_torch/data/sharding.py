"""Per-client data splits for the distributed setting (numpy, a copy of
``repro.data.sharding``: the same seed gives the same splits).

The paper: "each compute node can have its own local data set ... or can
share the same data sets", and the theory [27] covers both iid and
heterogeneous data. We provide:

- ``iid``            — windows shuffled then striped round-robin;
- ``contiguous``     — each client gets a contiguous time span
                       (heterogeneous: regimes differ across clients);
- ``shared``         — every client sees the full data set (paper's
                       "share the same data sets" mode).
"""

from __future__ import annotations

import numpy as np


def client_splits(n_samples: int, n_clients: int, mode: str = "iid",
                  seed: int = 0) -> list[np.ndarray]:
    idx = np.arange(n_samples)
    if mode == "shared":
        return [idx.copy() for _ in range(n_clients)]
    if mode == "iid":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_samples)
        return [np.sort(perm[c::n_clients]) for c in range(n_clients)]
    if mode == "contiguous":
        bounds = np.linspace(0, n_samples, n_clients + 1).astype(int)
        return [idx[bounds[c]:bounds[c + 1]] for c in range(n_clients)]
    raise ValueError(f"unknown split mode {mode!r}")
