"""Typed CLI / config system for the apps.

The port's own copy of ``nvblox_mindmap_tpu/utils/config.py`` (upstream
``mindmap/cli/args.py``): the dataclass argument classes (``ModelArgs``,
``SystemArgs``, ``DataGenArgs``, ``ClosedLoopArgs``, ``SimulationArgs`` and
the apps' ``TrainingAppArgs``, ``DataGenAppArgs``, ``OpenLoopAppArgs``,
``ClosedLoopAppArgs``, ``ValidateDemosAppArgs``, each with the port's
``--device``), the
argparse bridge (every field is a ``--flag``), JSON save / load, and the
checkpoint overlay: when a checkpoint is given, the ``ModelArgs`` frozen in
the sibling ``training_args.json`` override the command line, so a model is
never rebuilt differently than it was trained (upstream cli/args.py:303-353).
Both packages parse the same argv into the same ``args_to_dict``.

``model_config_from_args`` builds the port's ``DiffuserActorConfig``. Two of
its fields the flax model infers and the port sizes up front: ``data_type``
(the port's default is ``"mesh"``, so it is always set from the args) and
``vertex_feature_dim`` (the width of the dataset's vertex features: 3 for a
``--feature_type rgb`` dataset, 768 for RADIO), which the app reads from
its first batch.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import enum
import json
import os
import re
from typing import List, Optional, Tuple, Type

from nvblox_mindmap_torch.data.data_types import DataType
from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod
from nvblox_mindmap_torch.mapping.constants import Tasks
from nvblox_mindmap_torch.models.feature_extractors import FeatureExtractorType

DATAGEN_ARGUMENT_FILE_NAME = "datagen_args.json"
TRAINING_ARGUMENT_FILE_NAME = "training_args.json"
CLOSED_LOOP_ARGUMENT_FILE_NAME = "closed_loop_args.json"


def parse_two_3d_bounds(bounds_str: str) -> Tuple[List[float], List[float]]:
    cleaned = re.sub(r"[ \[\]()]", "", bounds_str)
    try:
        vec = [float(v) for v in cleaned.split(",")]
    except ValueError:
        vec = []
    if len(vec) != 6:
        raise ValueError(
            f"Expected 6 comma-separated numbers like "
            f'"[-0.1,-0.1,0],[0.1,0.1,0]" (min xyz, max xyz); got '
            f"{bounds_str!r}"
        )
    lo, hi = vec[:3], vec[3:]
    if not all(a <= b for a, b in zip(lo, hi)):
        raise ValueError(f"min must be <= max per axis; got {bounds_str!r}")
    return lo, hi


@dataclasses.dataclass
class ModelArgs:
    """Model-construction + model-input arguments (frozen into checkpoints)."""

    use_keyposes: int = 1
    extra_keyposes_around_grasp_events: Optional[List[int]] = None
    keypose_detection_mode: Optional[KeyposeDetectionMode] = None
    add_external_cam: bool = False
    gripper_encoding_mode: str = "binary"
    only_sample_keyposes: bool = False
    image_size: Tuple[int, int] = (512, 512)
    feature_image_size: Tuple[int, int] = (32, 32)
    # CLS/register token count of the (converted) ViT backbone; None uses the
    # hub default (1). Must match the 'prefix_tokens' in --backbone_weights.
    feature_num_prefix_tokens: Optional[int] = None
    embedding_dim: int = 120
    num_vis_ins_attn_layers: int = 2
    use_instruction: int = 0
    fps_subsampling_factor: int = 5
    use_fps: int = 1
    rotation_parametrization: str = "6D_from_query"
    quaternion_format: str = "wxyz"
    diffusion_timesteps: int = 100
    num_history: int = 3
    prediction_horizon: int = 1
    relative_action: int = 0
    lang_enhanced: int = 0
    data_type: DataType = DataType.RGBD_AND_MESH
    encode_openness: int = 1
    feature_type: FeatureExtractorType = FeatureExtractorType.RADIO_V25_B
    use_shared_feature_encoder: int = 0
    vertex_sampling_method: VertexSamplingMethod = (
        VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT
    )
    num_vertices_to_sample: int = 2048
    rgbd_min_depth_threshold: float = 0.0
    pos_loss: float = 30.0
    rot_loss: float = 10.0
    gripper_loss: float = 1.0
    apply_random_transforms: int = 0
    apply_geometry_noise: int = 0
    pos_noise_stddev_m: float = 0.01
    rot_noise_stddev_deg: float = 0.01
    encoder_dropout: float = 0.0
    diffusion_dropout: float = 0.0
    predictor_dropout: float = 0.0
    task: Optional[Tasks] = None
    random_translation_range_m: Tuple[List[float], List[float]] = (
        [-0.1, -0.1, 0.0],
        [0.1, 0.1, 0.0],
    )
    random_rpy_range_deg: Tuple[List[float], List[float]] = (
        [0.0, 0.0, -90.0],
        [0.0, 0.0, 90.0],
    )


@dataclasses.dataclass
class DataGenArgs:
    include_dynamic: bool = False
    validate_demos_with_gt_poses: int = 1
    voxel_size_m: Optional[float] = None
    projective_appearance_integrator_measurement_weight: Optional[float] = None
    demos_datagen: str = "0"
    save_serialized_nvblox_map_to_disk: bool = False


@dataclasses.dataclass
class ClosedLoopArgs:
    demos_closed_loop: str = "0"
    num_retries: int = 1
    demo_mode: str = "closed_loop_wait"
    max_num_steps_to_goal: int = 40
    terminate_after_n_steps: Optional[int] = None
    max_intermediate_distance_m: Optional[float] = None
    eval_file_path: Optional[str] = None
    record_camera_output_path: Optional[str] = None
    record_videos: bool = False
    video_size: Tuple[int, int] = (320, 320)
    gt_goals_subsampling_factor: int = 5
    # K > 1 fuses K i.i.d. diffusion draws per goal into a consensus
    # prediction (one batched device program; see
    # closed_loop/policies.aggregate_trajectory_samples). Default 1 =
    # reference parity (single stochastic DDPM draw).
    prediction_samples: int = 1
    # Reverse-diffusion sampler for live inference. Defaults reproduce the
    # reference's closed-loop protocol (stochastic DDPM at the training
    # timestep count); "--serving_scheduler ddim
    # --serving_num_inference_steps 10" is the production serving mode the
    # reference ships DDPM->DDIM conversion for
    # (reference diffuser_actor/converter.py:51+), validated closed-loop in
    # docs/data/task_success_mug_in_drawer_ddim.json.
    serving_scheduler: str = "ddpm"
    serving_num_inference_steps: Optional[int] = None
    # Few-step timestep spacing: "leading" (diffusers default, what the
    # reference's converted DDIM runs) or "trailing" (chain starts at t=T-1
    # where the init really is pure noise; the better few-step config —
    # ops/schedulers.DiffusionSchedule.timesteps docstring).
    serving_timestep_spacing: str = "leading"


@dataclasses.dataclass
class SystemArgs:
    seed: int = 0
    ignore_model_args_json: bool = False
    checkpoint: Optional[str] = None
    fpn_checkpoint: Optional[str] = None
    # Converted pretrained backbone weights (.npz; see
    # docs/pages/pretrained_weights.md). Required whenever a non-RGB feature
    # extractor forward runs (rgbd-type training from scratch). Not a
    # ModelArg: checkpoints are self-contained (the backbone is saved with
    # the model).
    backbone_weights: Optional[str] = None
    dataset: Optional[str] = None
    base_log_dir: str = "train_logs"
    wandb_name: Optional[str] = None
    wandb_mode: str = "disabled"
    wandb_entity: Optional[str] = None


@dataclasses.dataclass
class SimulationArgs:
    headless: bool = False
    num_envs: int = 1
    hdf5_file: Optional[str] = None
    background_env_usd_path: Optional[str] = None
    render_settings: str = "default"
    sim_device: str = "cpu"
    verbose: bool = False
    disable_fabric: bool = False


@dataclasses.dataclass
class TrainingAppArgs(ModelArgs, SystemArgs, DataGenArgs):
    max_episodes_per_task: int = 100
    eval_only: bool = False
    save_checkpoint: bool = True
    # "msgpack" (best.ckpt / last.ckpt files) or "orbax" (best/ and last/
    # directories written asynchronously: training/orbax_checkpoint.py).
    checkpoint_backend: str = "msgpack"
    demos_train: str = "0"
    demos_valset: Optional[str] = None
    # A packed-epoch directory (scripts/pack_dataset, data/packed.py): train
    # from it, staged on the device once, instead of the streaming loader.
    packed_dataset: Optional[str] = None
    # Equal-mass sampling across demo-index groups (e.g. "0-7,8-39" for an
    # expert + DAgger-corrective mix; data/loader.py). Applies to the train
    # loader only. Upstream has no counterpart.
    balance_demo_groups: Optional[str] = None
    include_failed_demos: bool = False
    exp_name: str = "mindmap-tpu Training"
    # The port's device ("cuda" unless "cpu" is asked for; no fallback).
    # Not a JAX flag: args_to_dict leaves it out, so both packages freeze
    # the same training_args.json.
    device: str = "cuda"
    num_workers: int = 0
    num_workers_for_test_dataset: Optional[int] = None
    batch_size: int = 32
    batch_size_val: int = 32
    initial_learning_rate: float = 1e-4
    learning_rate_end_factor: float = 0.5
    learning_rate_convergence_percentage: float = 0.75
    train_iters: int = 100000
    accumulate_grad_batches: int = 1
    val_freq: int = 100
    print_timers_freq: int = 1000
    print_progress_freq: int = 100
    num_batches_per_train_eval: int = 10
    num_batches_per_test_eval: int = -1
    # Validation-sampler cost: DDIM-10 by default; <=0 = full DDPM sampling.
    eval_num_inference_steps: int = 10
    eval_scheduler: str = "ddim"
    # Activation recomputation in the train step ("none" | "dots" |
    # "dots_no_batch" | "nothing"; trainer.TrainerConfig.remat_policy).
    remat_policy: str = "none"
    max_episode_length: int = 5
    viz_freq: int = 200
    skip_train_val: bool = False
    sampling_weighting_type: str = "uniform"

    def process_args(self):
        if self.add_external_cam and self.data_type == DataType.RGBD_AND_MESH:
            raise ValueError("RGBD_AND_MESH data type has only been tested with ego-cam")


@dataclasses.dataclass
class DataGenAppArgs(ModelArgs, SimulationArgs, SystemArgs, DataGenArgs):
    output_dir: Optional[str] = None
    add_depth_noise: bool = False
    max_num_attempts: int = 5
    max_num_steps: int = -1
    # The port's device, as in TrainingAppArgs.
    device: str = "cuda"

    def process_args(self):
        if self.add_external_cam and self.data_type == DataType.RGBD_AND_MESH:
            raise ValueError("RGBD_AND_MESH data type has only been tested with ego-cam")


@dataclasses.dataclass
class OpenLoopAppArgs(ModelArgs, SystemArgs):
    demos_open_loop: str = "0"
    # Headless visualization: write per-sample PLY clouds here when set
    # (feature-PCA colors + prediction attention colors).
    ply_output_dir: Optional[str] = None
    # The port's device, as in TrainingAppArgs.
    device: str = "cuda"

    def process_args(self):
        pass


@dataclasses.dataclass
class ClosedLoopAppArgs(ModelArgs, SimulationArgs, SystemArgs, DataGenArgs,
                        ClosedLoopArgs):
    visualize_robot_state: bool = False
    # The port's device, as in TrainingAppArgs.
    device: str = "cuda"

    def process_args(self):
        assert self.prediction_horizon == 1 or self.demo_mode != "execute_gt_goals"


@dataclasses.dataclass
class ValidateDemosAppArgs(SimulationArgs, SystemArgs, ClosedLoopArgs):
    # The port's device, as in TrainingAppArgs (validation itself is host
    # numpy).
    device: str = "cuda"

    def process_args(self):
        pass


# -----------------------------------------------------------------------------
# argparse bridge + JSON persistence
# -----------------------------------------------------------------------------

_ENUM_TYPES = (DataType, FeatureExtractorType, VertexSamplingMethod,
               KeyposeDetectionMode, Tasks)


def _parse_value(field_type, raw: str):
    origin = getattr(field_type, "__origin__", None)
    if field_type in (int, float, str):
        return field_type(raw)
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes")
    for et in _ENUM_TYPES:
        if field_type is et:
            return et(raw)
    if origin in (list, List):
        inner = field_type.__args__[0]
        return [inner(v) for v in raw.replace(",", " ").split()]
    if origin in (tuple, Tuple):
        parts = raw.replace(",", " ").split()
        inners = field_type.__args__
        if len(inners) == 2 and inners[1] is Ellipsis:
            return tuple(inners[0](v) for v in parts)
        if inners and getattr(inners[0], "__origin__", None) in (list, List):
            return parse_two_3d_bounds(raw)
        return tuple(t(v) for t, v in zip(inners, parts))
    if origin is not None and str(origin) == "typing.Union":  # Optional[...]
        args = [a for a in field_type.__args__ if a is not type(None)]
        if raw.lower() in ("none", ""):
            return None
        return _parse_value(args[0], raw)
    return raw


def parse_args(cls: Type, argv: Optional[List[str]] = None):
    """Parse CLI args into a dataclass instance (every field is a --flag)."""
    parser = argparse.ArgumentParser(prog=cls.__name__)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name in fields:
        parser.add_argument(f"--{name}", type=str, default=None)
    # Strict parsing: an unknown or misspelled flag errors (upstream's Tap
    # CLI does), instead of training with the default value.
    ns = parser.parse_args(argv)
    instance = cls()
    for name, field in fields.items():
        raw = getattr(ns, name)
        if raw is not None:
            setattr(instance, name, _parse_value(field.type_resolved
                    if hasattr(field, "type_resolved") else _resolve_type(cls, field),
                    raw))
    if hasattr(instance, "process_args"):
        instance.process_args()
    # Upstream accepts "analog" but never implements it (cli/args.py);
    # reject it instead of training with silently binary grippers.
    mode = getattr(instance, "gripper_encoding_mode", "binary")
    if mode != "binary":
        raise NotImplementedError(
            f"gripper_encoding_mode={mode!r} is not implemented (only "
            "'binary'; upstream accepts 'analog' but ignores it)"
        )
    return instance


def _resolve_type(cls, field):
    """Resolve string annotations (from __future__ annotations)."""
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(field.name, str)


# Fields of the port's own (not in the JAX package's argument classes).
PORT_ONLY_FIELDS = ("device",)


def args_to_dict(args) -> dict:
    def encode(v):
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, tuple):
            return list(v)
        return v

    return {f.name: encode(getattr(args, f.name)) for f in dataclasses.fields(args)
            if f.name not in PORT_ONLY_FIELDS}


def save_args(args, path: str):
    with open(path, "w") as f:
        json.dump(args_to_dict(args), f, indent=2, default=str)


def load_args_dict(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def extract_args_belonging_to_class(args_dict: dict, cls: Type) -> dict:
    keys = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in args_dict.items() if k in keys}


def _coerce(cls, name: str, value):
    import typing

    hints = typing.get_type_hints(cls)
    t = hints.get(name)
    if value is None or t is None:
        return value
    origin = getattr(t, "__origin__", None)
    if origin is not None and str(origin) == "typing.Union":
        args = [a for a in t.__args__ if a is not type(None)]
        t = args[0] if args else t
    for et in _ENUM_TYPES:
        if t is et and not isinstance(value, et):
            return et(value)
    if getattr(t, "__origin__", None) in (tuple, Tuple) and isinstance(value, list):
        return tuple(value)
    return value


def update_model_args_from_checkpoint(cli_args):
    """Overlay the ModelArgs subset from the checkpoint's frozen args.

    Only ModelArgs fields are overwritten; training/eval knobs stay as given
    on the CLI (upstream cli/args.py:303-353).
    """
    if not getattr(cli_args, "checkpoint", None):
        return cli_args
    if getattr(cli_args, "ignore_model_args_json", False):
        print("Loading checkpoint without loading model args. Danger Will Robinson!")
        return cli_args
    args_path = os.path.join(
        os.path.dirname(str(cli_args.checkpoint)), TRAINING_ARGUMENT_FILE_NAME
    )
    if not os.path.isfile(args_path):
        print(f"Requested model args path {args_path} does not exist.")
        return cli_args
    loaded = load_args_dict(args_path)
    model_args = extract_args_belonging_to_class(loaded, ModelArgs)
    updated = copy.deepcopy(cli_args)
    for k, v in model_args.items():
        setattr(updated, k, _coerce(type(updated), k, v))
    return updated


def model_config_from_args(args: ModelArgs, vertex_feature_dim: Optional[int] = None):
    """The port's ``DiffuserActorConfig`` from ModelArgs (upstream
    checkpoint.py:55). ``vertex_feature_dim``: the dataset's vertex-feature
    width (None keeps the config's default, 768)."""
    from nvblox_mindmap_torch.embodiments.base import EmbodimentType
    from nvblox_mindmap_torch.embodiments.registry import (
        get_embodiment_type_from_task,
        task_predicts_head_yaw,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
    from nvblox_mindmap_torch.models.loss import LossWeights

    ngrippers = 1
    predict_head_yaw = False
    if args.task is not None:
        if get_embodiment_type_from_task(args.task) == EmbodimentType.HUMANOID:
            ngrippers = 2
        predict_head_yaw = task_predicts_head_yaw(args.task)
    extra = {} if vertex_feature_dim is None else {"vertex_feature_dim": int(vertex_feature_dim)}
    return DiffuserActorConfig(
        embedding_dim=args.embedding_dim,
        num_vis_ins_attn_layers=args.num_vis_ins_attn_layers,
        nhist=args.num_history,
        ngrippers=ngrippers,
        prediction_horizon=args.prediction_horizon,
        data_type=DataType(args.data_type).value,
        feature_type=args.feature_type,
        feature_image_size=tuple(args.feature_image_size),
        feature_num_prefix_tokens=args.feature_num_prefix_tokens,
        fps_subsampling_factor=args.fps_subsampling_factor,
        use_fps=bool(args.use_fps),
        use_instruction=bool(args.use_instruction),
        encode_openness=bool(args.encode_openness),
        use_shared_feature_encoder=bool(args.use_shared_feature_encoder),
        rotation_parametrization="6D"
        if "6D" in args.rotation_parametrization
        else "quat",
        quaternion_format=args.quaternion_format,
        diffusion_timesteps=args.diffusion_timesteps,
        relative=bool(args.relative_action),
        lang_enhanced=bool(args.lang_enhanced),
        predict_head_yaw=predict_head_yaw,
        encoder_dropout=args.encoder_dropout,
        diffusion_dropout=args.diffusion_dropout,
        predictor_dropout=args.predictor_dropout,
        loss_weights=LossWeights(
            pos_loss=args.pos_loss,
            rot_loss=args.rot_loss,
            gripper_loss=args.gripper_loss,
        ),
        **extra,
    )
