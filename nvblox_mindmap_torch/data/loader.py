"""Data-loader assembly: item routing, transform stacks, prefetching loader.

The port's own copy of ``nvblox_mindmap_tpu/data/loader.py`` (upstream
``mindmap/data_loading/dataset_files_by_encoding_method.py`` and
``dataset.py:get_dataloader``). The loader yields model-ready numpy batch
dicts (unpacked, channel-last) and builds the next batches on background
threads, so host IO overlaps the step on the card: one prefetch thread with
the dataset's own transforms, or an ordered pool of worker threads, each
with its own transform clone seeded by ``SeedSequence([seed, 1 + epoch,
worker, t_idx])``. The same seed gives the JAX loader's batches bit for bit.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nvblox_mindmap_torch.data.batching import collate_batch, unpack_batch
from nvblox_mindmap_torch.data.data_types import (
    DataType,
    includes_depth_camera,
    includes_mesh,
    includes_rgb,
)
from nvblox_mindmap_torch.data.dataset import (
    DemoDataset,
    SamplingWeightingType,
)
from nvblox_mindmap_torch.data.item_names import (
    COMMON_RUNTIME_ITEMS,
    GT_POLICY_STATE_PRED_ITEM_NAME,
    MESH_ITEMS,
    NVBLOX_VERTEX_FEATURES_ITEM_NAME,
    POLICY_STATE_HISTORY_ITEM_NAME,
)
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.data.sampler import WeightedEpochSampler
from nvblox_mindmap_torch.data.transforms import (
    DepthTransformer,
    GeometryAugmentor,
    GeometryNoiser,
    RgbTransformer,
    VertexSampler,
)
from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase


def get_item_names_by_data_type(
    data_type: DataType, embodiment_specific_items: Dict
) -> List[str]:
    item_names = list(COMMON_RUNTIME_ITEMS)
    if includes_rgb(data_type):
        item_names.extend(embodiment_specific_items["rgb"])
    if includes_depth_camera(data_type):
        item_names.extend(embodiment_specific_items["depth"])
    if includes_mesh(data_type):
        item_names.extend(MESH_ITEMS)
    return item_names


def get_transforms_by_data_type(
    data_type: DataType,
    embodiment_specific_items: Dict,
    apply_random_transforms: bool = False,
    apply_geometry_noise: bool = False,
    pos_noise_stddev_m: float = 0.0,
    rot_noise_stddev_deg: float = 0.0,
    random_translation_range_m: Optional[Tuple] = None,
    random_rpy_range_deg: Optional[Tuple] = None,
    num_vertices_to_sample: Optional[int] = None,
    vertex_sampling_method: Optional[VertexSamplingMethod] = None,
    seed: int = 0,
) -> Dict[str, list]:
    transforms = defaultdict(list)
    rng = np.random.default_rng(seed)

    if apply_random_transforms:
        assert random_translation_range_m is not None
        assert random_rpy_range_deg is not None
        augmentor = GeometryAugmentor(
            random_translation_range_m, random_rpy_range_deg, rng
        )
        transforms[POLICY_STATE_HISTORY_ITEM_NAME].append(augmentor)
        transforms[GT_POLICY_STATE_PRED_ITEM_NAME].append(augmentor)
        if data_type == DataType.MESH:
            transforms[NVBLOX_VERTEX_FEATURES_ITEM_NAME].append(augmentor)
        else:
            raise NotImplementedError(
                f"Random transforms unsupported for data type: {data_type}"
            )

    if apply_geometry_noise:
        noiser = GeometryNoiser(pos_noise_stddev_m, rot_noise_stddev_deg, rng)
        transforms[POLICY_STATE_HISTORY_ITEM_NAME].append(noiser)
        if includes_mesh(data_type):
            transforms[NVBLOX_VERTEX_FEATURES_ITEM_NAME].append(noiser)
        else:
            raise NotImplementedError(
                f"Geometry noise unsupported for data type: {data_type}"
            )

    if includes_rgb(data_type):
        for rgb_item in embodiment_specific_items["rgb"]:
            transforms[rgb_item].append(RgbTransformer())
    if includes_depth_camera(data_type):
        for depth_item in embodiment_specific_items["depth"]:
            if "png" in depth_item:
                transforms[depth_item].append(DepthTransformer())
    if includes_mesh(data_type):
        transforms[NVBLOX_VERTEX_FEATURES_ITEM_NAME].append(
            VertexSampler(num_vertices_to_sample, vertex_sampling_method, rng)
        )
    return dict(transforms)


class DataLoader:
    """Batched iterator over a DemoDataset with background prefetch."""

    def __init__(
        self,
        dataset: DemoDataset,
        embodiment: EmbodimentBase,
        data_type: DataType,
        batch_size: int,
        add_external_cam: bool = False,
        rgbd_min_depth_threshold: float = 0.0,
        sampler: Optional[WeightedEpochSampler] = None,
        drop_last: bool = True,
        prefetch: int = 2,
        num_workers: int = 1,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.embodiment = embodiment
        self.data_type = data_type
        self.batch_size = batch_size
        self.add_external_cam = add_external_cam
        self.rgbd_min_depth_threshold = rgbd_min_depth_threshold
        self.sampler = sampler
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self._epoch = 0

    def _index_batches(self) -> List[List[int]]:
        if self.sampler is not None:
            # The sampler handles sharding itself (interleaved shards).
            order = list(iter(self.sampler))
        else:
            # Sequential order still honors data-parallel sharding - silently
            # serving every shard the full dataset would duplicate gradients.
            order = list(range(len(self.dataset)))[
                self.shard_index :: self.num_shards
            ]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _make_batch(
        self, indices: Sequence[int], transforms: Optional[Dict] = None
    ) -> Dict:
        if transforms is None:
            samples = [self.dataset[i] for i in indices]
        else:
            samples = [
                self.dataset.getitem_with_transforms(i, transforms)
                for i in indices
            ]
        collated = collate_batch(samples)
        return unpack_batch(
            self.embodiment,
            collated,
            self.data_type,
            self.add_external_cam,
            self.rgbd_min_depth_threshold,
        )

    def _worker_transforms(self, worker_idx: int, epoch: int) -> Dict:
        """Per-worker transform-stack clone with its own deterministic RNG.

        The torch DataLoader worker model that upstream trains with (each
        worker draws from its own seeded stream): results are reproducible
        for a fixed (seed, num_workers, epoch) and differ across num_workers
        settings, as upstream's do.
        """
        import copy

        cloned = copy.deepcopy(self.dataset.transforms)
        # Each transform gets an INDEPENDENT stream (distinct spawn key per
        # transform): seeding them identically would make e.g. the vertex
        # subsample a deterministic function of the augmentation translation,
        # silently correlating augmentations whenever num_workers>1.
        t_idx = 0
        seen: set = set()
        for stack in cloned.values():
            for t in stack:
                # The augmentor object is shared across stacks (one coherent
                # draw per sample) - reseed each unique OBJECT exactly once.
                if hasattr(t, "_rng") and id(t) not in seen:
                    seen.add(id(t))
                    t._rng = np.random.default_rng(
                        np.random.SeedSequence(
                            [self.seed, 1 + epoch, worker_idx, t_idx]
                        )
                    )
                    t_idx += 1
        return cloned

    def __len__(self) -> int:
        return len(self._index_batches())

    def __iter__(self):
        batches = self._index_batches()
        epoch = self._epoch
        self._epoch += 1
        if self.prefetch <= 0 or not batches:
            for indices in batches:
                yield self._make_batch(indices)
            return
        nw = min(self.num_workers, len(batches))
        if nw <= 1:
            yield from self._iter_single_worker(batches)
        else:
            yield from self._iter_pool(batches, nw, epoch)

    def _iter_single_worker(self, batches):
        """One prefetch thread using the dataset's own (locked) transforms -
        the fully deterministic path, independent of num_workers."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        # Bound now, used in the finally below: at interpreter shutdown the
        # `queue` module global may already be torn down, and referencing it
        # from a generator's cleanup would raise a spurious TypeError.
        empty_exc = queue.Empty

        def _put(item) -> bool:
            # Bounded put that aborts when the consumer abandoned the
            # generator (e.g. evaluate_nsteps breaking early) so the worker
            # thread and its queued batches don't leak.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for indices in batches:
                    if stop.is_set():
                        return
                    try:
                        batch = self._make_batch(indices)
                    except Exception as e:  # propagate to the consumer
                        # Swallowing would end the epoch early and silently
                        # train on a truncated subset forever.
                        _put(e)
                        return
                    if not _put(batch):
                        return
            finally:
                _put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so a worker blocked on a full queue can observe the stop
            # flag and exit promptly.
            try:
                while True:
                    q.get_nowait()
            except empty_exc:
                pass
            thread.join(timeout=5.0)

    def _iter_pool(self, batches, nw: int, epoch: int):
        """N worker threads, static round-robin batch assignment, results
        delivered strictly in batch order with a bounded in-flight window.

        Worker w builds batches w, w+nw, ... with its own transform clone
        (deterministic for fixed (seed, num_workers, epoch)); the consumer
        yields seq 0,1,2,... The window caps completed-but-unconsumed batches
        so a fast worker can't buffer the whole epoch in RAM. Deadlock-free:
        the worker holding the next-to-consume seq is always inside the
        window, so it never blocks.
        """
        results: Dict[int, object] = {}
        fatal: list = []  # worker-body failures outside per-batch handling
        cond = threading.Condition()
        stop = threading.Event()
        state = {"next_seq": 0}
        window = max(self.prefetch, 2) + nw

        def worker(w: int):
            # The whole body is guarded: a worker dying outside the per-batch
            # try (transform cloning, MemoryError, ...) must surface to the
            # consumer, not leave it waiting forever on a seq that will never
            # be posted while sibling workers idle inside the window.
            try:
                transforms = self._worker_transforms(w, epoch)
                for seq in range(w, len(batches), nw):
                    with cond:
                        while (
                            not stop.is_set()
                            and seq - state["next_seq"] >= window
                        ):
                            cond.wait(0.1)
                    if stop.is_set():
                        return
                    try:
                        batch = self._make_batch(batches[seq], transforms)
                    except Exception as e:  # delivered in-order
                        batch = e
                    with cond:
                        results[seq] = batch
                        cond.notify_all()
            except BaseException as e:
                with cond:
                    fatal.append(e)
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(nw)
        ]
        for t in threads:
            t.start()
        try:
            for seq in range(len(batches)):
                with cond:
                    while seq not in results:
                        if fatal:
                            raise fatal[0]
                        cond.wait(0.5)
                        if seq not in results and not any(
                            t.is_alive() for t in threads
                        ):
                            if fatal:
                                raise fatal[0]
                            raise RuntimeError(
                                f"loader workers exited without batch {seq}"
                            )
                    item = results.pop(seq)
                    state["next_seq"] = seq + 1
                    cond.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            with cond:
                results.clear()
                cond.notify_all()
            for t in threads:
                t.join(timeout=5.0)


def _balance_demo_group_weights(
    weights: np.ndarray, dataset: DemoDataset, groups_spec: str
) -> np.ndarray:
    """Scale per-sample weights so each demo-index group carries equal total
    sampling mass. Every demo in the dataset must belong to exactly one
    group, and every group must contribute >0 mass — silent emptiness would
    quietly train on one source only."""
    from nvblox_mindmap_torch.data.dataset import get_indices_from_range_str

    group_sets = [
        frozenset(get_indices_from_range_str(r))
        for r in groups_spec.split(",")
    ]
    demo_index = {
        path: int(os.path.basename(path).rsplit("_", 1)[-1])
        for path in dataset.demo_paths
    }
    sample_group = np.empty(len(dataset), dtype=np.int64)
    for i in range(len(dataset)):
        path, _ = dataset.locate(i)
        gids = [g for g, s in enumerate(group_sets) if demo_index[path] in s]
        assert len(gids) == 1, (
            f"demo {path} (index {demo_index[path]}) matches {len(gids)} "
            f"groups of balance_demo_groups={groups_spec!r}; demos must "
            "belong to exactly one group"
        )
        sample_group[i] = gids[0]
    weights = np.asarray(weights, dtype=np.float64).copy()
    for g in range(len(group_sets)):
        mass = weights[sample_group == g].sum()
        assert mass > 0, (
            f"balance group {g} ({sorted(group_sets[g])[:4]}...) has zero "
            "sampling mass"
        )
        weights[sample_group == g] /= mass
    return weights


def get_data_loader_by_data_type(
    embodiment: EmbodimentBase,
    dataset_path: str,
    demos: str,
    num_workers: int,  # >1 enables the pool of batch-building threads
    batch_size: int,
    use_keyposes: bool,
    data_type: DataType,
    only_sample_keyposes: bool,
    extra_keyposes_around_grasp_events: Sequence[int],
    keypose_detection_mode: KeyposeDetectionMode,
    include_failed_demos: bool,
    sampling_weighting_type: SamplingWeightingType,
    num_history: int,
    prediction_horizon: int,
    apply_random_transforms: bool = False,
    apply_geometry_noise: bool = False,
    pos_noise_stddev_m: float = 0.0,
    rot_noise_stddev_deg: float = 0.0,
    add_external_cam: bool = False,
    num_vertices_to_sample: Optional[int] = None,
    vertex_sampling_method: Optional[VertexSamplingMethod] = None,
    random_translation_range_m: Optional[Tuple] = None,
    random_rpy_range_deg: Optional[Tuple] = None,
    rgbd_min_depth_threshold: float = 0.0,
    num_shards: int = 1,
    shard_index: int = 0,
    seed: int = 0,
    drop_last: bool = True,
    balance_demo_groups: Optional[str] = None,
) -> Tuple[DataLoader, Optional[WeightedEpochSampler]]:
    """Build the full train/eval loader for a data type (upstream's API).

    ``balance_demo_groups``: comma-separated demo-index ranges (same syntax
    as ``demos``, e.g. ``"0-7,8-39"``); each group's total sampling mass is
    normalized to be equal, on top of ``sampling_weighting_type``'s
    per-sample weights: the JAX package's extension (upstream has none) for
    mixed expert + corrective datasets."""
    items = embodiment.get_camera_item_names_by_encoding_method(add_external_cam)
    item_names = get_item_names_by_data_type(data_type, items)
    transforms = get_transforms_by_data_type(
        data_type=data_type,
        embodiment_specific_items=items,
        apply_random_transforms=apply_random_transforms,
        apply_geometry_noise=apply_geometry_noise,
        pos_noise_stddev_m=pos_noise_stddev_m,
        rot_noise_stddev_deg=rot_noise_stddev_deg,
        random_translation_range_m=random_translation_range_m,
        random_rpy_range_deg=random_rpy_range_deg,
        num_vertices_to_sample=num_vertices_to_sample,
        vertex_sampling_method=vertex_sampling_method,
        seed=seed,
    )
    dataset = DemoDataset(
        dataset_path,
        demos=demos,
        embodiment=embodiment,
        item_names=item_names,
        transforms=transforms,
        only_sample_keyposes=only_sample_keyposes,
        include_failed_demos=include_failed_demos,
        num_history=num_history,
        prediction_horizon=prediction_horizon,
        use_keyposes=use_keyposes,
        extra_keyposes_around_grasp_events=extra_keyposes_around_grasp_events,
        keypose_detection_mode=keypose_detection_mode,
    )
    sampler = None
    weights = None
    replacement = False
    if sampling_weighting_type != SamplingWeightingType.NONE:
        weights = dataset.get_sample_weights(sampling_weighting_type, use_keyposes)
        replacement = sampling_weighting_type != SamplingWeightingType.UNIFORM
    if balance_demo_groups:
        # Source balancing for mixed datasets (e.g. expert + on-policy
        # corrective demos): without it, N corrective demos dilute the
        # nominal data N:M at the sample level. Equal-mass groups need draws
        # proportional to weight, so sampling is with replacement.
        weights = _balance_demo_group_weights(
            np.ones(len(dataset)) if weights is None else weights,
            dataset, balance_demo_groups,
        )
        replacement = True
    if weights is not None:
        sampler = WeightedEpochSampler(
            weights,
            num_samples=len(dataset),
            replacement=replacement,
            seed=seed,
            num_shards=num_shards,
            shard_index=shard_index,
        )
    loader = DataLoader(
        dataset,
        embodiment,
        data_type,
        batch_size,
        add_external_cam=add_external_cam,
        rgbd_min_depth_threshold=rgbd_min_depth_threshold,
        sampler=sampler,
        drop_last=drop_last,
        num_workers=num_workers,
        num_shards=num_shards,
        shard_index=shard_index,
        seed=seed,
    )
    return loader, sampler


def get_data_loader_without_augmentations(
    embodiment: EmbodimentBase,
    dataset_path: str,
    demos: str,
    num_workers: int,
    batch_size: int,
    use_keyposes: bool,
    data_type: DataType,
    extra_keyposes_around_grasp_events: Sequence[int],
    keypose_detection_mode: KeyposeDetectionMode,
    num_history: int,
    prediction_horizon: int,
    add_external_cam: bool = False,
    num_vertices_to_sample: Optional[int] = None,
    vertex_sampling_method: Optional[VertexSamplingMethod] = None,
    sampling_weighting_type: SamplingWeightingType = SamplingWeightingType.UNIFORM,
    include_failed_demos: bool = False,
    rgbd_min_depth_threshold: float = 0.0,
    num_shards: int = 1,
    shard_index: int = 0,
    seed: int = 0,
):
    """Evaluation loader with all augmentations disabled (upstream
    data_loading/dataset_files_by_encoding_method.py:154-205)."""
    return get_data_loader_by_data_type(
        embodiment=embodiment,
        dataset_path=dataset_path,
        demos=demos,
        num_workers=num_workers,
        batch_size=batch_size,
        use_keyposes=use_keyposes,
        data_type=data_type,
        only_sample_keyposes=False,
        extra_keyposes_around_grasp_events=extra_keyposes_around_grasp_events,
        keypose_detection_mode=keypose_detection_mode,
        include_failed_demos=include_failed_demos,
        sampling_weighting_type=sampling_weighting_type,
        num_history=num_history,
        prediction_horizon=prediction_horizon,
        apply_random_transforms=False,
        apply_geometry_noise=False,
        add_external_cam=add_external_cam,
        num_vertices_to_sample=num_vertices_to_sample,
        vertex_sampling_method=vertex_sampling_method,
        rgbd_min_depth_threshold=rgbd_min_depth_threshold,
        num_shards=num_shards,
        shard_index=shard_index,
        seed=seed,
        # Evaluation must see every sample; dropping the tail partial batch
        # (or a whole sub-batch-size val set) silently skews metrics.
        drop_last=False,
    )
