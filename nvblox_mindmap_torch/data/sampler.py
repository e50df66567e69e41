"""Sampling: weighted random sampling + per-process (data-parallel) sharding.

A copy of ``nvblox_mindmap_tpu/data/sampler.py`` (numpy only), which
replaces upstream's torch ``WeightedRandomSampler`` + catalyst
``DistributedSamplerWrapper``. All processes draw the same global sample
sequence from a shared seed, then take an interleaved shard - the
partitioning of ``DistributedSampler`` (shuffled, tail dropped to make the
length divisible). The trainer's ``run_training`` calls ``set_epoch``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class WeightedEpochSampler:
    """Seeded weighted sampling with epoch-varying streams.

    - UNIFORM semantics: permutation (no replacement).
    - weighted semantics: draw len(weights) samples with replacement,
      probability proportional to the weights.
    """

    def __init__(
        self,
        weights: np.ndarray,
        num_samples: Optional[int] = None,
        replacement: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples or len(self.weights)
        self.replacement = replacement
        if not replacement:
            # A permutation can yield at most len(weights) indices; clamping
            # keeps __len__ consistent with what iteration produces (the
            # trainer's epoch accounting is derived from len()).
            self.num_samples = min(self.num_samples, len(self.weights))
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _global_indices(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.replacement:
            p = self.weights / self.weights.sum()
            global_order = rng.choice(
                len(self.weights), size=self.num_samples, replace=True, p=p
            )
        else:
            global_order = rng.permutation(len(self.weights))[: self.num_samples]
        # Distributed wrapper shuffle, shared across shards.
        global_order = global_order[rng.permutation(len(global_order))]
        # Drop tail to make evenly divisible.
        usable = (len(global_order) // self.num_shards) * self.num_shards
        return global_order[:usable]

    def __iter__(self) -> Iterator[int]:
        yield from self._global_indices()[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        return (self.num_samples // self.num_shards)

    def epoch_indices(self) -> List[int]:
        return list(iter(self))
