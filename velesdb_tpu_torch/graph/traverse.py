"""Batched BFS traversal with guardrails.

Counterpart of the reference's streaming BFS (``graph/streaming.rs:247``
``bfs_stream`` with max_depth/max_visited guardrails) and rayon parallel BFS
(``query/parallel_traversal.rs``). The re-architecture: the frontier is a
numpy array and each hop is ONE vectorized segment-gather over the CSR edge
arrays (``CsrView.neighbors_of``) — per-hop work is O(frontier edges) with no
per-node locking, the same shape as a device segment-sum (the rayon layer's
job is done by vectorization).

Guardrails (``guardrails.rs:37,279,343`` analog): max_depth, max_visited,
max_results, timeout.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from velesdb_tpu_torch.graph.edge_store import EdgeStore

__all__ = ["Guardrails", "bfs", "traverse", "GuardrailError"]


class GuardrailError(RuntimeError):
    """Raised when a traversal exceeds its guardrail budget."""


@dataclasses.dataclass(frozen=True)
class Guardrails:
    max_depth: int = 10
    max_visited: int = 1_000_000
    max_results: int = 100_000
    timeout_s: float = 30.0
    strict: bool = False  # raise instead of truncating


def bfs(
    edges: EdgeStore,
    starts,
    *,
    direction: str = "out",
    label: str | None = None,
    max_depth: int | None = None,
    guardrails: Guardrails | None = None,
):
    """Breadth-first reach: returns ``{node_id: depth}`` including starts.

    One vectorized frontier expansion per hop.
    """
    g = guardrails or Guardrails()
    depth_cap = g.max_depth if max_depth is None else min(max_depth, g.max_depth)
    t0 = time.monotonic()
    want = edges.label_id(label) if label is not None else None
    if label is not None and want is None:
        return {int(s): 0 for s in np.atleast_1d(np.asarray(starts, np.int64))}
    view = edges.csr(direction)
    frontier = np.unique(np.atleast_1d(np.asarray(starts, np.int64)))
    depths = {int(n): 0 for n in frontier}
    for depth in range(1, depth_cap + 1):
        if frontier.size == 0:
            break
        if time.monotonic() - t0 > g.timeout_s:
            if g.strict:
                raise GuardrailError("traversal timeout")
            break
        _src, dst, lab, _eid = view.neighbors_of(frontier)
        if want is not None:
            dst = dst[lab == want]
        if dst.size == 0:
            break
        nxt = np.unique(dst)
        fresh = np.asarray([n for n in nxt if int(n) not in depths], np.int64)
        if len(depths) + fresh.size > g.max_visited:
            if g.strict:
                raise GuardrailError("max_visited exceeded")
            fresh = fresh[: max(0, g.max_visited - len(depths))]
        for n in fresh:
            depths[int(n)] = depth
        frontier = fresh
    return depths


def traverse(
    edges: EdgeStore,
    start: int,
    *,
    direction: str = "out",
    label: str | None = None,
    max_depth: int = 3,
    guardrails: Guardrails | None = None,
):
    """Path-returning traversal: ``[(node, depth, path_edge_ids)]`` in BFS
    order (the reference's ``traverse`` surface for the REST/CLI graph ops).
    """
    g = guardrails or Guardrails()
    depth_cap = min(max_depth, g.max_depth)
    t0 = time.monotonic()
    view = edges.csr(direction)
    want = edges.label_id(label) if label is not None else None
    if label is not None and want is None:
        return [(int(start), 0, [])]
    results = [(int(start), 0, [])]
    visited = {int(start)}
    frontier = np.asarray([start], np.int64)
    paths: dict[int, list[int]] = {int(start): []}
    for depth in range(1, depth_cap + 1):
        if frontier.size == 0 or len(results) >= g.max_results:
            break
        if time.monotonic() - t0 > g.timeout_s:
            if g.strict:
                raise GuardrailError("traversal timeout")
            break
        src, dst, lab, eids = view.neighbors_of(frontier)
        if want is not None:
            keep = lab == want
            src, dst, eids = src[keep], dst[keep], eids[keep]
        nxt = []
        for s, d, e in zip(src, dst, eids):
            d = int(d)
            if d in visited:
                continue
            visited.add(d)
            path = paths[int(s)] + [int(e)]
            paths[d] = path
            results.append((d, depth, path))
            nxt.append(d)
            if len(results) >= g.max_results:
                break
        frontier = np.asarray(nxt, np.int64)
    return results
