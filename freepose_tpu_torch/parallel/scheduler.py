"""Work scheduling across hosts/cards — the SLURM-array replacement.

A WorkShard names this worker's slice of any indexable work list, resolved
from (in priority order) explicit arguments, the FREEPOSE_* env, or legacy
SLURM_ARRAY_TASK_ID for drop-in cluster compatibility. Counterpart of
freepose_tpu.parallel.scheduler without its jax.process_index branch: the
port resolves shards from the environment only.
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class WorkShard:
    index: int
    count: int

    def slice(self, n_items: int, chunk: int | None = None):
        """Indices of this worker's items.

        chunk=None: strided round-robin over items (balanced).
        chunk=k: contiguous blocks of k items per worker index (the
        reference's '30 scenes per task' pattern).
        """
        if chunk is None:
            return list(range(self.index, n_items, self.count))
        start = self.index * chunk
        return list(range(start, min(start + chunk, n_items)))


def current_shard(index: int | None = None, count: int | None = None) -> WorkShard:
    if index is not None and count is not None:
        return WorkShard(index, count)
    env = os.environ
    if "FREEPOSE_SHARD_INDEX" in env:
        return WorkShard(int(env["FREEPOSE_SHARD_INDEX"]), int(env.get("FREEPOSE_SHARD_COUNT", "1")))
    if "SLURM_ARRAY_TASK_ID" in env:
        return WorkShard(
            int(env["SLURM_ARRAY_TASK_ID"]),
            int(env.get("SLURM_ARRAY_TASK_COUNT", env.get("SLURM_ARRAY_TASK_MAX", "0")) or 1),
        )
    return WorkShard(0, 1)


def shard_items(items, shard: WorkShard | None = None, chunk: int | None = None):
    shard = shard or current_shard()
    return [items[i] for i in shard.slice(len(items), chunk)]
