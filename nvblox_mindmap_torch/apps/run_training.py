"""Training app: args -> loaders -> Trainer, on one GPU or data-parallel.

The port's counterpart of ``nvblox_mindmap_tpu/apps/run_training.py``
(upstream ``run_training.py``), with its flags and flow: keypose parameters
from the task tables, train and validation loaders (validation keeps its
tail batch), the pretrained-backbone guard for rgbd data types trained from
scratch, ``--checkpoint`` resume with the frozen-args overlay,
``--eval_only``, ``Trainer.run_training`` and the ``checkpoints/latest``
symlink. Evaluation samples through the flash kernels (the process-wide
attention impl is "flash" while the app runs, restored after it); train
steps run eager attention under autograd, as ``Trainer`` passes it.

Usage::

    python -m nvblox_mindmap_torch.apps.run_training \\
        --dataset <path> --task cube_stacking --data_type rgbd_and_mesh \\
        --feature_type radio_v25_b --backbone_weights <radio.npz> \\
        --demos_train 0-9 --demos_valset 10-11 --train_iters 1000

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. The JAX app's other modes:

- ``--packed_dataset <dir>`` trains from a packed epoch
  (``scripts/pack_dataset``), staged on the device once; each step takes a
  view of it. The four flags that shape batches at pack time are refused
  here. Validation keeps the streaming loader.
- ``--checkpoint_backend orbax`` writes ``best/`` and ``last/``
  asynchronously (``training/orbax_checkpoint.py``); ``--checkpoint`` takes
  such a directory.
- Under ``python -m torch.distributed.run --nproc_per_node N -m
  nvblox_mindmap_torch.apps.run_training ...`` it trains data-parallel,
  one device per rank (gloo with ``--device cpu``); ``--batch_size`` is the
  global batch and N must divide it.
"""
from __future__ import annotations

import logging
import os
import sys
from datetime import datetime
from typing import Any, Dict, List, Optional

import torch

from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
from nvblox_mindmap_torch.data.item_io import unpickle_zst
from nvblox_mindmap_torch.data.item_names import NVBLOX_VERTEX_FEATURES_ITEM_NAME
from nvblox_mindmap_torch.data.loader import get_data_loader_by_data_type
from nvblox_mindmap_torch.embodiments.registry import (
    TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS,
    TASK_TO_KEYPOSE_DETECTION_MODE,
    make_embodiment_for_task,
)
from nvblox_mindmap_torch.device import resolve_device
from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    set_default_attention_impl,
)
from nvblox_mindmap_torch.parallel.mesh import maybe_init_distributed
from nvblox_mindmap_torch.parallel.multihost import broadcast_object, get_rank
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.config import (
    TrainingAppArgs,
    args_to_dict,
    model_config_from_args,
    parse_args,
    update_model_args_from_checkpoint,
)
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger

logger = logging.getLogger("nvblox_mindmap_torch.run_training")


def resolve_keypose_params(args):
    extra = args.extra_keyposes_around_grasp_events
    if extra is None:
        extra = TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS[args.task]
    mode = args.keypose_detection_mode
    if mode is None:
        mode = TASK_TO_KEYPOSE_DETECTION_MODE[args.task]
    return extra, mode


def build_loaders(args, embodiment, num_shards: int = 1, shard_index: int = 0,
                  skip_train: bool = False, skip_val: bool = False):
    """(train loader, train sampler, validation loader). ``skip_train``
    leaves the train loader and sampler None (a packed epoch feeds
    training, so the train demos are not scanned twice); ``skip_val`` the
    validation loader (``scripts/pack_dataset`` never evaluates)."""
    extra, mode = resolve_keypose_params(args)
    weighting = SamplingWeightingType(args.sampling_weighting_type.lower())
    common = dict(
        embodiment=embodiment,
        dataset_path=args.dataset,
        num_workers=args.num_workers,
        use_keyposes=bool(args.use_keyposes),
        data_type=args.data_type,
        only_sample_keyposes=bool(args.only_sample_keyposes),
        extra_keyposes_around_grasp_events=extra,
        keypose_detection_mode=mode,
        include_failed_demos=args.include_failed_demos,
        num_history=args.num_history,
        prediction_horizon=args.prediction_horizon,
        add_external_cam=args.add_external_cam,
        num_vertices_to_sample=args.num_vertices_to_sample,
        vertex_sampling_method=args.vertex_sampling_method,
        rgbd_min_depth_threshold=args.rgbd_min_depth_threshold,
        num_shards=num_shards,
        shard_index=shard_index,
        seed=args.seed,
    )
    train_loader = train_sampler = val_loader = None
    if not skip_train:
        train_loader, train_sampler = get_data_loader_by_data_type(
            demos=args.demos_train,
            batch_size=args.batch_size,
            sampling_weighting_type=weighting,
            balance_demo_groups=args.balance_demo_groups,
            apply_random_transforms=bool(args.apply_random_transforms),
            apply_geometry_noise=bool(args.apply_geometry_noise),
            pos_noise_stddev_m=args.pos_noise_stddev_m,
            rot_noise_stddev_deg=args.rot_noise_stddev_deg,
            random_translation_range_m=args.random_translation_range_m,
            random_rpy_range_deg=args.random_rpy_range_deg,
            **common,
        )
    if not skip_val:
        val_loader, _ = get_data_loader_by_data_type(
            demos=args.demos_valset or args.demos_train,
            batch_size=args.batch_size_val,
            sampling_weighting_type=SamplingWeightingType.UNIFORM,
            # Keep the tail partial batch: a val set smaller than
            # batch_size_val would otherwise evaluate nothing.
            drop_last=False,
            **common,
        )
    return train_loader, train_sampler, val_loader


def vertex_feature_dim(dataset) -> Optional[int]:
    """The width of the dataset's vertex features (None without a mesh),
    read from its first item: flax infers it from the first batch, the port
    sizes the reconstruction encoder from it up front."""
    if NVBLOX_VERTEX_FEATURES_ITEM_NAME not in dataset.item_names:
        return None
    path = dataset.demo_info[dataset.demo_paths[0]][NVBLOX_VERTEX_FEATURES_ITEM_NAME][0]
    return int(unpickle_zst(path)["features"].shape[-1])


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the app; returns {"trainer", "checkpoint_dir", "best_loss",
    "start_iter", "val_loss" (with --eval_only)}."""
    previous_impl = get_default_attention_impl()
    try:
        return _run(argv)
    finally:
        set_default_attention_impl(previous_impl)


def _run(argv: Optional[List[str]]) -> Dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    cli_args = parse_args(TrainingAppArgs, argv)
    # Before joining the process group, so a bad launch fails on every rank
    # at once instead of waiting for its peers.
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if cli_args.batch_size % world_size:
        raise ValueError(f"--batch_size {cli_args.batch_size} does not split into the "
                         f"{world_size} ranks of WORLD_SIZE")
    device = resolve_device(None if cli_args.device == "cuda" else cli_args.device)
    maybe_init_distributed(device)
    args = update_model_args_from_checkpoint(cli_args)
    if args.task is None:
        raise ValueError("--task is required")
    if args.dataset is None:
        raise ValueError("--dataset is required")
    if args.packed_dataset:
        # Sampling and augmentation happen at pack time; on this invocation
        # they cannot touch the frozen batches, so they are refused, not
        # dropped without a word.
        ignored = [name for name, active in (
            ("apply_random_transforms", args.apply_random_transforms),
            ("apply_geometry_noise", args.apply_geometry_noise),
            ("balance_demo_groups", args.balance_demo_groups),
            ("sampling_weighting_type", args.sampling_weighting_type != "uniform"),
        ) if active]
        if ignored:
            raise ValueError(f"--packed_dataset replays frozen batches; {ignored} have "
                             "no effect here — pass them to pack_dataset instead")

    embodiment = make_embodiment_for_task(args.task)
    bounds = get_workspace_bounds(args.task)
    # Rank 0's clock names the run's directory on every rank.
    checkpoint_dir = broadcast_object(os.path.join(
        args.base_log_dir, "checkpoints", datetime.today().strftime("%Y.%m.%d-%H.%M.%S")))
    trainer_config = TrainerConfig(
        train_iters=args.train_iters,
        batch_size=args.batch_size,
        initial_learning_rate=args.initial_learning_rate,
        learning_rate_end_factor=args.learning_rate_end_factor,
        learning_rate_convergence_percentage=args.learning_rate_convergence_percentage,
        accumulate_grad_batches=args.accumulate_grad_batches,
        val_freq=args.val_freq,
        num_batches_per_train_eval=args.num_batches_per_train_eval,
        num_batches_per_test_eval=args.num_batches_per_test_eval,
        eval_num_inference_steps=(
            args.eval_num_inference_steps if args.eval_num_inference_steps > 0 else None),
        eval_scheduler=args.eval_scheduler,
        skip_train_val=args.skip_train_val,
        print_timers_freq=args.print_timers_freq,
        print_progress_freq=args.print_progress_freq,
        save_checkpoint=args.save_checkpoint,
        checkpoint_dir=checkpoint_dir,
        checkpoint_backend=args.checkpoint_backend,
        seed=args.seed,
        remat_policy=args.remat_policy,
    )
    # A non-RGB extractor inside the model (rgbd data types) starts from
    # pretrained weights unless a (self-contained) checkpoint is resumed.
    if args.data_type in ("rgbd", "rgbd_and_mesh") and not args.checkpoint:
        from nvblox_mindmap_torch.models.pretrained import require_backbone_weights

        require_backbone_weights(args.feature_type, args.backbone_weights,
                                 "training from scratch")
    os.makedirs(checkpoint_dir, exist_ok=True)
    rank = get_rank()
    metric_logger = None if rank else MetricLogger(
        use_wandb=args.wandb_mode != "disabled", wandb_project=args.exp_name,
        wandb_name=args.wandb_name, wandb_entity=args.wandb_entity,
        wandb_mode=args.wandb_mode, config=args_to_dict(args), artifact_dir=checkpoint_dir)

    train_loader, _, val_loader = build_loaders(args, embodiment,
                                                skip_train=bool(args.packed_dataset))
    model_config = model_config_from_args(
        args, vertex_feature_dim=vertex_feature_dim(val_loader.dataset))
    trainer = Trainer(model_config, trainer_config, bounds, device=device,
                      metric_logger=metric_logger, backbone_weights=args.backbone_weights)
    if args.packed_dataset:
        from nvblox_mindmap_torch.data.packed import PackedDeviceLoader

        # The rank's rows of every packed batch, staged on its device once.
        train_loader = PackedDeviceLoader(args.packed_dataset, mesh=trainer.mesh,
                                          seed=args.seed)
        logger.info("packed train feed: %d batches staged on %s from %s",
                    len(train_loader), trainer.device, args.packed_dataset)
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("convert_to_flash_attention returned sampler settings")

    start_iter, best_loss = 0, None
    if args.checkpoint:
        start_iter, best_loss = trainer.load_checkpoint(str(args.checkpoint))
        logger.info("Resumed from %s at iter %d", args.checkpoint, start_iter)
    else:
        trainer.init_state()
    result = {"trainer": trainer, "checkpoint_dir": checkpoint_dir, "start_iter": start_iter}

    if args.eval_only:
        val_loss, _ = trainer.evaluate_nsteps(val_loader, 0, -1, split="val-only")
        result.update(best_loss=best_loss, val_loss=val_loss)
        return result

    best_loss = trainer.run_training(train_loader, val_loader, start_iter=start_iter,
                                     best_loss=best_loss, args_dict=args_to_dict(args))
    result["best_loss"] = best_loss
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # A stable handle for chained workflows: rank 0 repoints
    # checkpoints/latest only after a run that wrote its last checkpoint
    # (last.ckpt, or last/ of the asynchronous backend), so a crashed run
    # never leaves it dangling while an older best exists.
    if rank == 0 and args.save_checkpoint and (
            os.path.exists(os.path.join(checkpoint_dir, "last.ckpt"))
            or os.path.isdir(os.path.join(checkpoint_dir, "last"))):
        latest = os.path.join(args.base_log_dir, "checkpoints", "latest")
        try:
            if os.path.islink(latest) or os.path.exists(latest):
                os.unlink(latest)
            os.symlink(os.path.basename(checkpoint_dir), latest)
        except OSError:
            pass  # no symlinks on this file system: pass explicit checkpoint paths
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
