"""Exact top-k nearest-neighbour search over device-resident feature banks.

Counterpart of freepose_tpu.ops.knn (none of it is a Pallas kernel there):
a brute-force `queries @ bank.T` and top-k, exact where a KD-tree would be
pointer-chasing. `topk_search_sharded` searches a bank split over a device
mesh's "model" axis (parallel/mesh.py): a local top-k on each shard, the
k x shards candidates gathered, then a global top-k.
"""
from __future__ import annotations

import torch


def topk_lowest_index(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the lowest index as
    jax.lax.top_k orders them (torch.topk leaves the order of ties
    unspecified): (values, indices), each [..., k]."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def topk_search(bank: torch.Tensor, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """bank [M, D] (rows L2-normalised for cosine), queries [N, D] ->
    (scores [N, k], indices [N, k]) by inner product in fp32; ties go to
    the lower bank row."""
    scores = torch.matmul(queries.float(), bank.float().T)
    return topk_lowest_index(scores, k)


def topk_search_sharded(bank_shards, queries: torch.Tensor, k: int, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a bank split into equal row blocks over the mesh's
    "model" axis (parallel/mesh.py:shard_bank's BankShards), -> (scores
    [N, k], global row indices [N, k]) on mesh.first. Each shard searches
    its own rows on its device and adds its row offset; the k x shards
    candidates are gathered in shard order and a global top-k breaks ties
    by the lowest row, as topk_search on the whole bank does. The zero
    padding rows (at and past bank_shards.n_rows) score -inf, so they never
    enter the top-k."""
    from freepose_tpu_torch.parallel.mesh import gather

    shard_rows = bank_shards[0].shape[0]
    scores, rows = [], []
    for j, shard in enumerate(bank_shards):
        s, i = topk_search(shard, queries.to(shard.device), min(k, shard_rows))
        gi = i + j * shard_rows
        s = torch.where(gi < bank_shards.n_rows, s, -torch.inf)
        scores.append(s.T)
        rows.append(gi.T)
    s_all, gi_all = gather(scores, mesh).T, gather(rows, mesh).T  # [N, shards * k], shard order
    top_s, pos = topk_lowest_index(s_all, k)
    return top_s, torch.take_along_dim(gi_all, pos, dim=1)


def fine_rerank_scores(fine_feats: torch.Tensor, query: torch.Tensor, topk: int) -> torch.Tensor:
    """fine_feats [C, V, D] per-view features of C candidates, query [D] ->
    [C], the mean of each candidate's top-`topk` per-view cosine scores."""
    scores = torch.einsum("cvd,d->cv", fine_feats.float(), query.float())
    return torch.topk(scores, topk, dim=-1).values.mean(dim=-1)


def knn_median_lookup(bank: torch.Tensor, values: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """For each query, the median of `values` over its k nearest bank rows
    (the CLIP text-prior scale lookup, k = 11). An even k averages the two
    middle values, as jnp.median does (torch.median would take the lower)."""
    _, idx = topk_search(bank, queries, k)
    neigh = torch.sort(values[idx], dim=-1).values  # [N, k]
    return (neigh[:, (k - 1) // 2] + neigh[:, k // 2]) / 2.0
