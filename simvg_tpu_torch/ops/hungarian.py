"""Exact linear-sum assignment (Hungarian matching) on the host.

Port of ``simvg_tpu/ops/hungarian.py``.  The JAX package solves on the
device because a jitted step cannot leave it; the reference SimVG solves
with scipy on the host (detrex ``HungarianMatcher``).  The port follows the
reference: the problems are tiny (1x1 for the flagship, at most 10x10 for
GRefCOCO), so the detached fp32 costs of a whole batch, every decoder layer
stacked, go to the host in one copy, are solved in numpy, and the indices
come back in one copy.

``_solve_rect`` is the JAX solver step for step: successive shortest
augmenting paths (Dijkstra over columns) with dual variables, the scipy
``rectangular_lsap`` algorithm, in float32 with the first-index ``argmin``
tie rule, so both packages pick the same assignment among equal-cost ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _solve_rect(cost: np.ndarray, row_valid: np.ndarray) -> np.ndarray:
    """Matches every VALID row of cost [R, C] (R <= C) to a distinct
    column.  Returns col4row int32 [R]: the column of each valid row, -1 for
    invalid rows."""
    r_dim, c_dim = cost.shape
    if r_dim > c_dim:
        raise ValueError(f"need rows <= cols, got {cost.shape}")
    cost = np.nan_to_num(cost.astype(np.float32), posinf=3e38, neginf=-3e38)
    u = np.zeros(r_dim, np.float32)
    v = np.zeros(c_dim, np.float32)
    col4row = np.full(r_dim, -1, np.int32)
    row4col = np.full(c_dim, -1, np.int32)
    rows = np.arange(r_dim)

    for cur_row in range(r_dim):
        if not row_valid[cur_row]:
            continue
        # Dijkstra over columns for the shortest augmenting path
        shortest = np.full(c_dim, np.inf, np.float32)
        path = np.full(c_dim, -1, np.int32)
        sr = np.zeros(r_dim, bool)
        sr[cur_row] = True
        sc = np.zeros(c_dim, bool)
        i, min_val, sink = cur_row, np.float32(0.0), -1
        while sink < 0:
            reduced = min_val + cost[i] - u[i] - v
            better = (reduced < shortest) & ~sc
            shortest = np.where(better, reduced, shortest)
            path = np.where(better, np.int32(i), path)
            masked = np.where(sc, np.float32(np.inf), shortest)
            j = int(np.argmin(masked))
            min_val = masked[j]
            sc[j] = True
            nxt = row4col[j]
            if nxt < 0:
                sink = j
            else:
                i = nxt
            sr[i] = True

        # dual updates
        u[cur_row] += min_val
        others = sr & (rows != cur_row)
        shortest_at_col4row = shortest[np.clip(col4row, 0, None)]
        u = np.where(others, u + min_val - shortest_at_col4row, u)
        v = np.where(sc, v - (min_val - shortest), v)

        # augment along the alternating path ending at the sink
        j = sink
        while True:
            i = path[j]
            row4col[j] = i
            j, col4row[i] = col4row[i], j
            if i == cur_row:
                break
    return col4row


def _assign_np(cost: np.ndarray, col_valid: np.ndarray):
    """One problem: cost [N, M] (N >= M) -> (col4row [N], row4col [M])."""
    n, m = cost.shape
    row4col = _solve_rect(cost.T, col_valid)  # targets as rows
    col4row = np.full(n, -1, np.int32)
    hit = row4col >= 0
    col4row[row4col[hit]] = np.arange(m, dtype=np.int32)[hit]
    return col4row, row4col


def hungarian_assign(
    cost: torch.Tensor,  # [..., N, M], N predictions >= M targets
    col_valid: Optional[torch.Tensor] = None,  # [..., M] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matches rows (predictions) to columns (targets) at least total cost,
    for every problem of the leading batch dimensions, on the host.

    Returns int64 tensors on ``cost``'s device: col4row [..., N] (the
    matched valid column of each row, else -1) and row4col [..., M] (the
    matched row of each valid column, -1 for invalid columns).  One copy to
    the host and one back, whatever the batch.
    """
    *batch, n, m = cost.shape
    if n < m:
        raise ValueError(f"hungarian_assign requires rows >= cols, got "
                         f"{tuple(cost.shape)}")
    if col_valid is None:
        col_valid = torch.ones(*batch, m, dtype=torch.bool,
                               device=cost.device)
    # cost and validity travel together: one device-to-host copy
    packed = torch.cat([cost.detach().float().reshape(-1, n * m),
                        col_valid.reshape(-1, m).float()], dim=1).cpu().numpy()
    hungarian_assign.round_trips += 1
    c4r = np.empty((packed.shape[0], n), np.int64)
    r4c = np.empty((packed.shape[0], m), np.int64)
    for p, row in enumerate(packed):
        c4r[p], r4c[p] = _assign_np(row[:n * m].reshape(n, m), row[n * m:] > 0)
    out = torch.from_numpy(np.concatenate([c4r, r4c], axis=1)).to(cost.device)
    return (out[:, :n].reshape(*batch, n), out[:, n:].reshape(*batch, m))


hungarian_assign.round_trips = 0  # host round trips; chip_smoke.py reads it
