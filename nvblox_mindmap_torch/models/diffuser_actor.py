"""DiffuserActor: 3D denoising-diffusion keypose policy (torch).

Port of ``nvblox_mindmap_tpu/models/diffuser_actor.py``, for every data
type (``rgbd``, ``mesh``, ``rgbd_and_mesh``), with or without language
(``use_instruction``, ``lang_enhanced``):

- ``prepare_inputs``: split closedness from the history, optionally make the
  history (and the RGB-D point clouds) relative to the current pose,
  normalize positions, point clouds and vertices to the workspace and
  quaternions to continuous 6D, scale uint8 RGB to [0, 1] on the device;
- ``DiffuserActor.encode``: image tokens (frozen backbone, ``encode_images``)
  then mesh-vertex tokens, with ``use_instruction`` the instruction encoded
  and the context cross-attending to it, gripper-history queries,
  feature-space FPS;
- ``DiffuserActor.denoise``: one ``DiffusionHead`` pass;
- ``sample_trajectory``: DDPM or DDIM reverse diffusion over the denoiser,
  then unnormalize (and restore the absolute pose in relative mode);
- ``diffusion_train_loss``: the training objective, epsilon prediction at a
  random timestep (``DiffuserActor.forward`` is its training-shaped pass).

The model is built with the flax initialisers (``layers.init_as_flax_``), so
a model trained from scratch starts from the JAX package's distribution.

The JAX sampler is one ``lax.scan``; here it is a Python loop of eager
steps. Its noise, and the training loss's noise and timesteps, come either
from the caller (parity tests take them from the JAX key splits) or from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.geometry.rotations import (
    quaternion_invert,
    quaternion_multiply,
)
from nvblox_mindmap_torch.models.diffusion_head import DiffusionHead
from nvblox_mindmap_torch.models.encoder import Encoder
from nvblox_mindmap_torch.models.feature_extractors import FeatureExtractorType
from nvblox_mindmap_torch.models.layers import init_as_flax_
from nvblox_mindmap_torch.models.loss import LossWeights, compute_loss
from nvblox_mindmap_torch.models.normalization import (
    normalize_pointcloud,
    normalize_pos,
    normalize_trajectory,
    unnormalize_trajectory,
)
from nvblox_mindmap_torch.ops.schedulers import DiffusionSchedule, make_schedule
from nvblox_mindmap_torch.utils.timers import span

DATA_TYPES = ("rgbd", "mesh", "rgbd_and_mesh")


@dataclasses.dataclass(frozen=True)
class DiffuserActorConfig:
    """Static model configuration: the fields of the JAX config the port uses.

    ``vertex_feature_dim`` is the width of the mesh vertex features (flax
    infers it from the first batch; torch sizes ``reconstruction_encoder``
    up front): 768 for RADIO features, 3 for the RGB fixtures. ``data_type``
    defaults to ``"mesh"`` here (the JAX default is ``"rgbd_and_mesh"``).
    ``backbone_chunk_images`` runs the frozen backbone over chunks of that
    many images (``Encoder.encode_images``; None = one call).
    """

    embedding_dim: int = 120
    num_attn_heads: int = 8
    num_vis_ins_attn_layers: int = 2
    nhist: int = 3
    ngrippers: int = 1
    prediction_horizon: int = 1
    data_type: str = "mesh"  # "rgbd" | "mesh" | "rgbd_and_mesh"
    feature_type: FeatureExtractorType = FeatureExtractorType.RGB
    feature_image_size: Tuple[int, int] = (32, 32)
    # CLS/register token count of the ViT backbone (None = hub default).
    feature_num_prefix_tokens: Optional[int] = None
    backbone_chunk_images: Optional[int] = None
    vertex_feature_dim: int = 768
    fps_subsampling_factor: int = 5
    use_fps: bool = True
    use_instruction: bool = False
    lang_enhanced: bool = False
    encode_openness: bool = True
    use_shared_feature_encoder: bool = False
    rotation_parametrization: str = "6D"
    quaternion_format: str = "wxyz"
    diffusion_timesteps: int = 100
    relative: bool = False
    predict_head_yaw: bool = False
    encoder_dropout: float = 0.0
    diffusion_dropout: float = 0.0
    predictor_dropout: float = 0.0
    loss_weights: LossWeights = LossWeights()

    def __post_init__(self):
        if "6D" not in self.rotation_parametrization:
            raise NotImplementedError(
                "rotation_parametrization must contain '6D' (got "
                f"{self.rotation_parametrization!r}); quaternion-space "
                "diffusion is not implemented"
            )
        if self.data_type not in DATA_TYPES:
            raise ValueError(f"data_type must be one of {DATA_TYPES}, got {self.data_type!r}")
        if self.use_shared_feature_encoder and self.data_type == "mesh":
            # The shared encoder routes mesh features through the image
            # feature encoder, which only exists when images are encoded.
            raise ValueError(
                "use_shared_feature_encoder requires image inputs "
                "(data_type 'rgbd' or 'rgbd_and_mesh'); with data_type "
                "'mesh' there is no image encoder to share"
            )
        object.__setattr__(self, "feature_type", FeatureExtractorType(self.feature_type))
        object.__setattr__(self, "feature_image_size", tuple(self.feature_image_size))

    def schedules(self, kind: str = "ddpm") -> Tuple[DiffusionSchedule, DiffusionSchedule]:
        """(position, rotation) noise schedules."""
        return (
            make_schedule("scaled_linear", self.diffusion_timesteps, kind=kind),
            make_schedule("squaredcos_cap_v2", self.diffusion_timesteps, kind=kind),
        )


class DiffuserActor(nn.Module):
    """The policy's parameterized compute: ``encode`` and ``denoise``.

    Built on ``device`` (default ``cuda``; raises when CUDA is absent and no
    device is given) with the flax initialisers, in eval mode; ``train()``
    turns dropout on. Every method with attention takes ``impl`` (None = the
    process-wide default of ``ops.attention``).
    """

    def __init__(self, config: DiffuserActorConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.encoder = Encoder(
            embedding_dim=cfg.embedding_dim,
            nhist=cfg.nhist,
            ngrippers=cfg.ngrippers,
            num_attn_heads=cfg.num_attn_heads,
            fps_subsampling_factor=cfg.fps_subsampling_factor,
            data_type=cfg.data_type,
            encode_openness=cfg.encode_openness,
            feature_type=cfg.feature_type,
            feature_image_size=cfg.feature_image_size,
            feature_num_prefix_tokens=cfg.feature_num_prefix_tokens,
            use_shared_feature_encoder=cfg.use_shared_feature_encoder,
            vertex_feature_dim=cfg.vertex_feature_dim,
            dropout=cfg.encoder_dropout,
            backbone_chunk_images=cfg.backbone_chunk_images,
            use_instruction=cfg.use_instruction,
            num_vis_ins_attn_layers=cfg.num_vis_ins_attn_layers,
        )
        self.head = DiffusionHead(
            embedding_dim=cfg.embedding_dim,
            num_attn_heads=cfg.num_attn_heads,
            rotation_dim=6,
            nhist=cfg.nhist,
            ngrippers=cfg.ngrippers,
            predict_head_yaw=cfg.predict_head_yaw,
            diffusion_dropout=cfg.diffusion_dropout,
            predictor_dropout=cfg.predictor_dropout,
            use_instruction=cfg.use_instruction,
            lang_enhanced=cfg.lang_enhanced,
            prediction_horizon=cfg.prediction_horizon,
        )
        init_as_flax_(self)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.traj_encoder.weight.device

    def encode(
        self,
        rgb_obs: Optional[torch.Tensor],
        pcd_obs: Optional[torch.Tensor],
        pcd_valid_mask: Optional[torch.Tensor],
        vertex_features: Optional[torch.Tensor],
        vertices: Optional[torch.Tensor],
        vertices_valid_mask: Optional[torch.Tensor],
        instruction: Optional[torch.Tensor],
        gripper_history: torch.Tensor,
        curr_closedness: torch.Tensor,
        impl: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Encode images, mesh, instruction and gripper history into fixed
        denoiser inputs.

        Shapes (channel-last): rgb_obs (B, ncam, H, W, 3); pcd_obs likewise;
        pcd_valid_mask (B, ncam, H, W); vertex_features (B, Nv, C); vertices
        (B, Nv, 3); instruction (B, T, 512), read with ``use_instruction``;
        gripper_history (B, nhist, G, 9); curr_closedness (B, nhist, G, 1).
        The context is the image tokens, then the mesh's.
        """
        with span("model/encode"):
            cfg = self.config
            parts_feats, parts_pos, parts_mask = [], [], []

            def add(feats, pos, mask):
                parts_feats.append(feats)
                parts_pos.append(pos)
                parts_mask.append(mask if mask is not None else torch.ones(
                    feats.shape[:2], dtype=torch.bool, device=feats.device))

            if cfg.data_type in ("rgbd", "rgbd_and_mesh"):
                add(*self.encoder.encode_images(rgb_obs, pcd_obs, valid_mask=pcd_valid_mask))
            if cfg.data_type in ("mesh", "rgbd_and_mesh"):
                add(*self.encoder.encode_feature_pointcloud(vertex_features, vertices),
                    vertices_valid_mask)
            context_feats = torch.cat(parts_feats, dim=1)
            context = torch.cat(parts_pos, dim=1)
            context_mask = torch.cat(parts_mask, dim=1)

            instr_feats = None
            if cfg.use_instruction:
                if instruction is None:
                    raise ValueError("use_instruction needs an instruction (B, T, 512)")
                instr_feats, _ = self.encoder.encode_instruction(instruction)
                context_feats = self.encoder.vision_language_attention(context_feats, instr_feats,
                                                                       impl=impl)

            adaln_gripper_feats, _, gripper_attn_weights = (
                self.encoder.encode_gripper_history(
                    gripper_history, context_feats, context, curr_closedness, impl=impl
                )
            )
            if cfg.use_fps:
                fps_feats, fps_pos, fps_mask = self.encoder.run_fps(
                    context_feats, self.encoder.relative_pe(context), context_mask
                )
            else:
                fps_feats = context_feats
                fps_pos = self.encoder.relative_pe(context)
                fps_mask = context_mask
            return {
                "context_feats": context_feats,
                "context": context,
                "context_mask": context_mask,
                "instr_feats": instr_feats,
                "adaln_gripper_feats": adaln_gripper_feats,
                "fps_feats": fps_feats,
                "fps_pos": fps_pos,
                "fps_mask": fps_mask,
                "gripper_attn_weights": gripper_attn_weights,
            }

    def encode_prepared(self, prepared: Dict[str, Any],
                        impl: Optional[str] = None) -> Dict[str, Any]:
        """``encode`` on the output of ``prepare_inputs``."""
        return self.encode(
            prepared.get("rgbs"),
            prepared.get("pcds"),
            prepared.get("pcd_valid_mask"),
            prepared.get("vertex_features"),
            prepared.get("vertices"),
            prepared.get("vertices_valid_mask"),
            prepared.get("instruction"),
            prepared["gripper_history"],
            prepared["curr_closedness"],
            impl=impl,
        )

    def forward(self, prepared: Dict[str, Any], noisy_trajectory: torch.Tensor,
                timesteps: torch.Tensor, impl: Optional[str] = None):
        """Training-shaped pass: ``encode_prepared``, then one ``denoise``."""
        fixed = self.encode_prepared(prepared, impl=impl)
        return self.denoise(noisy_trajectory, timesteps, fixed, impl=impl)

    def denoise(self, trajectory: torch.Tensor, timestep: torch.Tensor,
                fixed_inputs: Dict[str, Any], impl: Optional[str] = None):
        """One denoiser pass: (B, L, G, 9) noisy traj -> (B, L, G, 10) eps+open."""
        return self.head(
            trajectory,
            timestep,
            context_feats=fixed_inputs["context_feats"],
            context=fixed_inputs["context"],
            context_mask=fixed_inputs["context_mask"],
            adaln_gripper_feats=fixed_inputs["adaln_gripper_feats"],
            fps_feats=fixed_inputs["fps_feats"],
            fps_pos=fixed_inputs["fps_pos"],
            fps_mask=fixed_inputs["fps_mask"],
            instr_feats=fixed_inputs.get("instr_feats"),
            impl=impl,
        )


def prepare_inputs(
    batch: Dict[str, Any],
    workspace_bounds,
    config: DiffuserActorConfig,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Pure-data preprocessing shared by training and inference.

    Expects batch keys (numpy arrays or tensors, channel-last):
    "gripper_history" (B, nhist, G, 8), and as the data type needs "rgbs"
    (B, ncam, H, W, 3, float in [0, 1] or uint8), "pcds" (B, ncam, H, W, 3),
    optional "pcd_valid_mask" (B, ncam, H, W), "vertex_features" (B, Nv, C),
    "vertices" (B, Nv, 3), optional "vertices_valid_mask" (B, Nv); optional
    "gt_gripper_pred" (B, L, G, 8), "gt_head_yaw" and "instruction"
    (B, T, 512). Returns tensors on
    ``device`` (default ``cuda``). In relative mode the point clouds move
    with the (single) gripper; mesh vertices stay absolute, as in the JAX
    package and upstream, and the shifted clouds are still bounds-checked
    against the absolute workspace.
    """
    with span("model/prepare_inputs"):
        device = resolve_device(device)

        def on_device(x):
            return None if x is None else torch.as_tensor(x, device=device)

        bounds = on_device(workspace_bounds).to(torch.float32)
        out: Dict[str, Any] = {}
        gripper_history = on_device(batch["gripper_history"])
        out["curr_closedness"] = gripper_history[..., 7:8]
        gripper_history = gripper_history[..., :7]
        out["current_pose"] = gripper_history[:, -1]  # (B, G, 7)
        pcds = on_device(batch.get("pcds"))
        gt = on_device(batch.get("gt_gripper_pred"))

        if config.relative:
            # Translate the history by the current pose; translate and rotate
            # the ground-truth trajectory.
            current_pos = out["current_pose"][..., :3]  # (B, G, 3)
            current_quat = out["current_pose"][..., 3:7]
            gripper_history = torch.cat(
                [gripper_history[..., :3] - current_pos[:, None], gripper_history[..., 3:]],
                dim=-1,
            )
            if pcds is not None:
                # RGB-D mode has a single gripper; pcds are (B, ncam, H, W, 3).
                pcds = pcds - current_pos[:, 0][:, None, None, None, :]
            if gt is not None:
                rel_pos = gt[..., :3] - current_pos[:, None]
                rel_quat = quaternion_multiply(
                    quaternion_invert(current_quat)[:, None], gt[..., 3:7]
                )
                gt = torch.cat([rel_pos, rel_quat, gt[..., 7:]], dim=-1)

        out["gripper_history"] = normalize_trajectory(
            gripper_history, bounds, config.rotation_parametrization,
            config.quaternion_format,
        )
        if pcds is not None:
            out["pcds"], in_bounds = normalize_pointcloud(pcds, bounds)
            valid = on_device(batch.get("pcd_valid_mask"))
            out["pcd_valid_mask"] = in_bounds if valid is None else (valid & in_bounds)
            rgbs = on_device(batch.get("rgbs"))
            if rgbs is not None and rgbs.dtype == torch.uint8:
                rgbs = rgbs.to(torch.float32) / 255.0
            out["rgbs"] = rgbs
        if batch.get("vertices") is not None:
            out["vertices"], _ = normalize_pos(on_device(batch["vertices"]), bounds)
            out["vertex_features"] = on_device(batch["vertex_features"])
            out["vertices_valid_mask"] = on_device(batch.get("vertices_valid_mask"))
        if gt is not None:
            if gt.shape[-1] != 8:
                raise ValueError(f"gt_gripper_pred must be (..., 8), got {tuple(gt.shape)}")
            out["gt_openness"] = gt[..., 7:]
            out["gt_gripper_pred"] = normalize_trajectory(
                gt[..., :7], bounds, config.rotation_parametrization,
                config.quaternion_format,
            )
        out["gt_head_yaw"] = on_device(batch.get("gt_head_yaw"))
        out["instruction"] = on_device(batch.get("instruction"))
        return out


def diffusion_train_loss(
    model: DiffuserActor,
    prepared: Dict[str, Any],
    noise: Optional[torch.Tensor] = None,
    timesteps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    impl: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Training objective: epsilon-prediction loss at a random timestep.

    The ground truth (``prepared["gt_gripper_pred"]``, (B, L, G, 9)) is
    noised by the position schedule on [..., :3] and the rotation schedule
    on [..., 3:9] at ``timesteps`` (B,), and the model's prediction is held
    to the noise by ``compute_loss``. ``noise`` (B, L, G, 9) and
    ``timesteps`` come from the caller or are drawn from ``generator`` (on
    the model's device). Returns the loss dict ("total", "pos", "rot",
    "gripper", optional "head_yaw").
    """
    cfg = model.config
    pos_sched, rot_sched = cfg.schedules()
    gt = prepared["gt_gripper_pred"]
    B = gt.shape[0]
    if (noise is None or timesteps is None) and generator is None:
        raise ValueError("pass noise and timesteps, or a torch.Generator")
    if noise is None:
        noise = torch.randn(gt.shape, generator=generator, device=gt.device, dtype=gt.dtype)
    if timesteps is None:
        timesteps = torch.randint(0, cfg.diffusion_timesteps, (B,), generator=generator,
                                  device=gt.device)
    noise = torch.as_tensor(noise, dtype=gt.dtype, device=gt.device)
    timesteps = torch.as_tensor(timesteps, device=gt.device)

    pos = pos_sched.add_noise(gt[..., :3], noise[..., :3], timesteps)
    rot = rot_sched.add_noise(gt[..., 3:9], noise[..., 3:9], timesteps)
    traj_pred, head_yaw_pred, _ = model(prepared, torch.cat([pos, rot], dim=-1), timesteps,
                                        impl=impl)
    return compute_loss(
        traj_pred,
        head_yaw_pred,
        noise,
        prepared.get("gt_openness"),
        prepared.get("gt_head_yaw"),
        loss_weights=cfg.loss_weights,
        predict_head_yaw=cfg.predict_head_yaw,
        rotation_form="6D",
    )


def sampler_noise(cfg: DiffuserActorConfig, batch_size: int, num_steps: int,
                  stochastic: bool, generator: torch.Generator, device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``sample_trajectory``'s noise for ``batch_size`` rows and
    ``num_steps`` steps, drawn from ``generator`` in its order: the initial
    noise (B, L, G, 9), then, when ``stochastic``, the step noise
    (T, B, L, G, 9) (else None)."""
    shape = (batch_size, cfg.prediction_horizon, cfg.ngrippers, 9)
    init_noise = torch.randn(shape, generator=generator, device=device)
    step_noise = None
    if stochastic:
        step_noise = torch.randn((num_steps,) + shape, generator=generator, device=device)
    return init_noise, step_noise


@torch.no_grad()
def sample_trajectory(
    model: DiffuserActor,
    prepared: Dict[str, Any],
    workspace_bounds,
    num_inference_steps: Optional[int] = None,
    scheduler_kind: str = "ddpm",
    stochastic: bool = True,
    normalized: bool = False,
    timestep_spacing: str = "leading",
    clip_sample: Optional[bool] = None,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Full reverse-diffusion sampling on the model's device.

    Noise: either ``init_noise`` (B, L, G, 9) with ``step_noise``
    (T, B, L, G, 9) (its [..., :3] feeds the position step and [..., 3:9]
    the rotation step; only read when ``stochastic``), or a
    ``torch.Generator`` on the model's device to draw both.

    Returns (trajectory (B, L, G, 8: pos+quat+openness prob),
             head_yaw (B, L, 1) or None,
             mean cross-attention weights (B, L*G, N), None under flash).
    With ``normalized=True`` the trajectory stays in normalized space
    (B, L, G, 10: pos3+6D+openness logit).
    """
    cfg = model.config
    device = model.device
    pos_sched, rot_sched = cfg.schedules(kind=scheduler_kind)
    if clip_sample is not None:
        pos_sched = dataclasses.replace(pos_sched, clip_sample=clip_sample)
        rot_sched = dataclasses.replace(rot_sched, clip_sample=clip_sample)
    fixed = model.encode_prepared(prepared)

    B = prepared["gripper_history"].shape[0]
    L, G = cfg.prediction_horizon, cfg.ngrippers
    timesteps = pos_sched.timesteps(num_inference_steps, spacing=timestep_spacing)
    T = timesteps.shape[0]
    step_ratio = cfg.diffusion_timesteps // T

    if init_noise is None:
        if generator is None:
            raise ValueError("pass init_noise and step_noise, or a torch.Generator")
        init_noise, step_noise = sampler_noise(cfg, B, T, stochastic, generator, device)
    elif stochastic and step_noise is None:
        raise ValueError("stochastic sampling with init_noise needs step_noise")
    trajectory = torch.as_tensor(init_noise, dtype=torch.float32, device=device)
    if stochastic:
        step_noise = torch.as_tensor(step_noise, dtype=torch.float32, device=device)

    weights_sum = None
    for i, t in enumerate(timesteps.tolist()):
        with span("sampler/step"):
            t_batch = torch.full((B,), float(t), device=device)
            pred, head_yaw, weights = model.denoise(trajectory, t_batch, fixed)
            prev_t = t - step_ratio
            noise = step_noise[i] if stochastic else None
            pos = pos_sched.step(
                pred[..., :3], t, trajectory[..., :3],
                noise=None if noise is None else noise[..., :3], prev_t=prev_t,
            )
            rot = rot_sched.step(
                pred[..., 3:9], t, trajectory[..., 3:9],
                noise=None if noise is None else noise[..., 3:9], prev_t=prev_t,
            )
            trajectory = torch.cat([pos, rot], dim=-1)
            if weights is not None:
                weights_sum = weights if weights_sum is None else weights_sum + weights
    # Openness and head yaw come from the final denoiser call; attention
    # weights are averaged over all steps.
    openness = pred[..., 9:]
    mean_weights = None if weights_sum is None else weights_sum / T

    trajectory = torch.cat([trajectory, openness], dim=-1)
    if normalized:
        return trajectory, head_yaw, mean_weights
    bounds = torch.as_tensor(workspace_bounds, dtype=torch.float32, device=device)
    trajectory = unnormalize_trajectory(
        trajectory, bounds, cfg.rotation_parametrization, cfg.quaternion_format
    )
    if cfg.relative:
        current_pos = prepared["current_pose"][..., :3]
        current_quat = prepared["current_pose"][..., 3:7]
        abs_pos = trajectory[..., :3] + current_pos[:, None]
        abs_quat = quaternion_multiply(current_quat[:, None], trajectory[..., 3:7])
        trajectory = torch.cat([abs_pos, abs_quat, trajectory[..., 7:]], dim=-1)
    if cfg.predict_head_yaw and head_yaw is not None:
        head_yaw = torch.clamp(head_yaw, -math.pi, math.pi - 1e-6)
    return trajectory, head_yaw, mean_weights
