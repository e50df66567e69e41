"""Training losses and evaluation metrics for the diffusion policy (torch).

Port of ``nvblox_mindmap_tpu/models/loss.py``: weighted L1 position + L1
rotation + BCE-with-logits openness + optional MSE head yaw (weights
30/10/1/1 by default), and the evaluation suite (per-axis distance error and
its std, bias, rotation L1, quaternion geodesic error in degrees, openness
L1, head-yaw error).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from portbench.reference.geometry.rotations import (
    quaternion_invert,
    quaternion_multiply,
    quaternion_to_axis_angle,
)

TRANS_LENGTH = 3


@dataclasses.dataclass(frozen=True)
class LossWeights:
    pos_loss: float = 30.0
    rot_loss: float = 10.0
    gripper_loss: float = 1.0
    head_yaw_loss: float = 1.0


def destructure_action(
    action: torch.Tensor, rotation_form: str
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Split an action into (position, rotation, openness-or-None)."""
    rot_length = {"quaternion": 4, "6D": 6}[rotation_form]
    if not TRANS_LENGTH + rot_length <= action.shape[-1] <= TRANS_LENGTH + rot_length + 1:
        raise ValueError(f"a {rotation_form} action has {TRANS_LENGTH + rot_length} or "
                         f"{TRANS_LENGTH + rot_length + 1} channels, got {action.shape[-1]}")
    end = TRANS_LENGTH + rot_length
    openness = action[..., end:] if action.shape[-1] > end else None
    return action[..., :TRANS_LENGTH], action[..., TRANS_LENGTH:end], openness


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits (mean), written as
    the JAX package writes it."""
    return torch.mean(
        torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def compute_loss(
    pred: torch.Tensor,
    head_yaw_pred: Optional[torch.Tensor],
    target: torch.Tensor,
    gt_openness: Optional[torch.Tensor],
    gt_head_yaw: Optional[torch.Tensor],
    loss_weights: LossWeights = LossWeights(),
    predict_head_yaw: bool = False,
    rotation_form: str = "6D",
) -> Dict[str, torch.Tensor]:
    """Weighted diffusion loss.

    Args:
        pred: (B, L, G, pos+rot+1) prediction (openness as logits).
        target: (B, L, G, pos+rot) noise / trajectory target.
        gt_openness: (B, L, G, 1) binary openness target.
        gt_head_yaw: (B, L, 1) head yaw target in [-pi, pi).

    Returns:
        dict with "total", "pos", "rot", "gripper" and optional "head_yaw".
    """
    if pred.shape[:-1] != target.shape[:-1]:
        raise ValueError(f"pred {tuple(pred.shape)} and target {tuple(target.shape)} differ")
    pred_trans, pred_rot, pred_openness = destructure_action(pred, rotation_form)
    gt_trans, gt_rot, _ = destructure_action(target, rotation_form)

    pos_loss = torch.mean(torch.abs(pred_trans - gt_trans))
    rot_loss = torch.mean(torch.abs(pred_rot - gt_rot))
    gripper_loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    if gt_openness is not None and gt_openness.numel() > 0:
        gripper_loss = bce_with_logits(pred_openness, gt_openness)

    total = (
        loss_weights.pos_loss * pos_loss
        + loss_weights.rot_loss * rot_loss
        + loss_weights.gripper_loss * gripper_loss
    )
    losses = {"pos": pos_loss, "rot": rot_loss, "gripper": gripper_loss}
    if predict_head_yaw:
        head_yaw_loss = torch.mean(torch.square(head_yaw_pred - gt_head_yaw))
        total = total + loss_weights.head_yaw_loss * head_yaw_loss
        losses["head_yaw"] = head_yaw_loss
    losses["total"] = total
    return losses


def compute_metrics(
    pred: torch.Tensor,
    head_yaw_pred: Optional[torch.Tensor],
    target: torch.Tensor,
    gt_head_yaw: Optional[torch.Tensor],
    predict_head_yaw: bool = False,
    rotation_form: str = "quaternion",
) -> Dict[str, torch.Tensor]:
    """Checkpoint-evaluation metrics on unnormalized (quaternion) actions."""
    if pred.shape[:-1] != target.shape[:-1]:
        raise ValueError(f"pred {tuple(pred.shape)} and target {tuple(target.shape)} differ")
    pred_trans, pred_rot, pred_openness = destructure_action(pred, rotation_form)
    gt_trans, gt_rot, gt_openness = destructure_action(target, rotation_form)

    metrics: Dict[str, torch.Tensor] = {}
    d2 = torch.square(pred_trans - gt_trans)
    d_axis = torch.sqrt(d2)
    d_norm = torch.sqrt(torch.sum(d2, dim=-1))
    metrics["distance_m"] = torch.mean(d_norm)
    metrics["distance_m_x"] = torch.mean(d_axis[..., 0])
    metrics["distance_m_y"] = torch.mean(d_axis[..., 1])
    metrics["distance_m_z"] = torch.mean(d_axis[..., 2])
    # The unbiased std (upstream's torch.std) is NaN for a single sample;
    # report the population std there instead, as the JAX package does.
    correction = 1 if d_norm.numel() > 1 else 0
    metrics["distance_m_std"] = torch.std(d_norm, correction=correction)
    metrics["distance_m_std_x"] = torch.std(d_axis[..., 0], correction=correction)
    metrics["distance_m_std_y"] = torch.std(d_axis[..., 1], correction=correction)
    metrics["distance_m_std_z"] = torch.std(d_axis[..., 2], correction=correction)
    metrics["bias"] = torch.mean(pred_trans - gt_trans, dim=(0, 1, 2))

    metrics["rot_l1"] = torch.mean(torch.sum(torch.abs(pred_rot - gt_rot), dim=-1))

    q_delta = quaternion_multiply(pred_rot, quaternion_invert(gt_rot))
    angle = torch.linalg.norm(quaternion_to_axis_angle(q_delta), dim=-1)
    metrics["rot_error_deg"] = torch.mean(angle * 180.0 / math.pi)

    if pred_openness is not None and gt_openness is not None:
        metrics["openness_l1"] = torch.mean(
            torch.sum(torch.abs(pred_openness - gt_openness), dim=-1)
        )
    if predict_head_yaw and head_yaw_pred is not None:
        metrics["head_yaw_error_deg"] = (
            torch.mean(torch.abs(head_yaw_pred - gt_head_yaw)) * 180.0 / math.pi
        )
    return metrics
