"""Plain edit-distance reference for stage 2: the least cost of aligning a
whole read to the assembly around its true origin, with free end gaps on
the assembly (semi-global: every read base is aligned or inserted).

A textbook banded dynamic programme in plain PyTorch, one query row per
step for a batch of reads; a row's left moves are taken in one pass as
`D[k] = k + cummin(X[k] - k)`. Substitutions, insertions and deletions
cost 1. Nothing here is shared with the program's aligners.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 28


def semiglobal_costs(queries: list[np.ndarray], targets: list[np.ndarray], offsets: list[int],
                     band: int = 256, device: str | torch.device = "cpu") -> np.ndarray:
    """Least semi-global edit cost of each query against its target.

    queries[r], targets[r]: int8 base codes; offsets[r]: where on targets[r]
    query position 0 is expected. The band covers target positions
    i + offsets[r] - band .. i + offsets[r] + band at query row i, so the
    cost is exact for any alignment whose path stays within `band` of that
    diagonal. Returns int64 [R]."""
    R = len(queries)
    if R == 0:
        return np.zeros(0, dtype=np.int64)
    dev = torch.device(device)
    n = torch.tensor([q.size for q in queries], device=dev)
    m = torch.tensor([t.size for t in targets], device=dev)
    off = torch.tensor(offsets, device=dev)
    n_max, m_max = int(n.max()), int(m.max())
    Q = torch.full((R, n_max), -1, dtype=torch.int8)
    T = torch.full((R, m_max), -2, dtype=torch.int8)
    for r in range(R):
        Q[r, : queries[r].size] = torch.from_numpy(queries[r].astype(np.int8))
        T[r, : targets[r].size] = torch.from_numpy(targets[r].astype(np.int8))
    Q, T = Q.to(dev), T.to(dev)
    K = 2 * band + 1
    k = torch.arange(K, device=dev)[None, :]
    inf = torch.full((R, 1), INF, dtype=torch.int64, device=dev)

    def cols(i: int) -> torch.Tensor:
        return i + off[:, None] - band + k  # target position j of each band cell

    j = cols(0)
    D = torch.where((j >= 0) & (j <= m[:, None]), 0, INF).to(torch.int64)  # free leading gap
    for i in range(1, n_max + 1):
        j = cols(i)
        inside = (j >= 0) & (j <= m[:, None])
        tc = T.gather(1, (j - 1).clamp(0, m_max - 1))
        sub = (Q[:, i - 1 : i] != tc).to(torch.int64)
        diag = torch.where((j >= 1) & inside, D + sub, INF)
        up = torch.cat([D[:, 1:], inf], dim=1) + 1  # same j on the row above
        X = torch.minimum(torch.minimum(diag, up), torch.full_like(diag, INF))
        X = torch.where(inside, X, INF)
        row = k + torch.cummin(X - k, dim=1).values
        row = torch.where(inside, torch.minimum(row, torch.full_like(row, INF)), INF)
        D = torch.where((i <= n)[:, None], row, D)
    j = n[:, None] + off[:, None] - band + k
    last = torch.where((j >= 0) & (j <= m[:, None]), D, INF)
    return last.min(dim=1).values.cpu().numpy()
