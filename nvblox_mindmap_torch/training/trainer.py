"""Trainer (torch): one GPU per process, data-parallel across processes.

Port of ``nvblox_mindmap_tpu/training/trainer.py``. The JAX trainer compiles
the whole step into one program on a 1-D device mesh; here the step is eager
PyTorch on the process's device (``parallel/mesh.py``: its ``DataMesh``):

- ``train_one_step``: ``prepare_inputs`` -> ``diffusion_train_loss`` ->
  backward -> ``Optimizer.step`` (AdamW, LinearLR, gradient accumulation).
  Its attention is the eager path, passed explicitly (``impl="eager"``):
  the flash kernels have no backward, and a train step keeps working after
  inference installed them as the process-wide default.
- ``eval_step`` / ``evaluate_nsteps``: the production sampler in normalized
  space (DDIM-10 by default), the loss against the normalized ground truth,
  the metrics on the unnormalized quaternion actions, means weighted by
  batch size, and the trajectory-figure hook. Sampling runs the configured
  attention impl, so with flash installed every eval batch runs both flash
  kernels.
- ``run_training``: the iteration loop with the epoch-seeded sampler
  (``set_epoch`` from the block base every ``set_epoch_every`` epochs; a
  packed epoch's loader takes the epoch itself), the next batch copied to
  the device while the current one trains (a batch already on the device,
  a packed epoch's view, is not copied), periodic evaluation and best/last
  checkpoints (``msgpack`` files, or the asynchronous ``orbax``
  directories of ``training/orbax_checkpoint.py``).

The noise and timesteps of step ``s`` come from a generator seeded by
(``seed``, ``s``), so a resumed run draws what a continued run draws; the
JAX package's ``jax.random`` streams are not reproduced. Dropout (0.0 by
default) draws from torch's global generator.

Under a process group (torchrun, ``parallel/mesh.maybe_init_distributed``)
each rank trains on its rows of the global batch, as the JAX trainer's
batch sharding does: the noise and timesteps are drawn for the global batch
and each rank takes its rows; after ``backward`` one all-reduce averages the
trainable gradients (never the frozen backbone's) and the losses over the
ranks, as JAX's psum over the data axis (the loss is a plain mean, so equal
shards give the global mean); a step of n ranks is then the step of one.
Each eval batch is sharded over the ranks the same way (trimmed to a
multiple of the ranks, as JAX trims it), and its metrics averaged over
them. Only rank 0 logs and writes
msgpack checkpoints and ``training_args.json``; every rank enters the
asynchronous backend's save.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nvblox_mindmap_torch.device import DeviceLike
from nvblox_mindmap_torch.models.diffuser_actor import (
    DiffuserActor,
    DiffuserActorConfig,
    diffusion_train_loss,
    prepare_inputs,
    sample_trajectory,
    sampler_noise,
)
from nvblox_mindmap_torch.models.layers import set_layer_checkpointing
from nvblox_mindmap_torch.models.loss import compute_loss, compute_metrics
from nvblox_mindmap_torch.models.normalization import unnormalize_trajectory
from nvblox_mindmap_torch.models.weights import load_flax_params
from nvblox_mindmap_torch.parallel.mesh import (
    local_rows,
    make_data_mesh,
    on_mesh_device,
    replicate,
    shard_batch,
)
from nvblox_mindmap_torch.parallel.multihost import mean_metrics_across_processes
from nvblox_mindmap_torch.training.checkpoint import (
    is_jax_checkpoint,
    load_checkpoint_file,
    read_jax_checkpoint,
    read_jax_opt_state,
    save_checkpoint,
    save_training_args,
)
from nvblox_mindmap_torch.training.optimizer import Optimizer, frozen_feature_extractor_mask
from nvblox_mindmap_torch.utils.timers import Timer, span, timer_status_string

logger = logging.getLogger("nvblox_mindmap_torch.trainer")

REMAT_POLICIES = ("none", "dots", "dots_no_batch", "nothing")


@dataclasses.dataclass
class TrainerConfig:
    train_iters: int = 100_000
    batch_size: int = 32
    initial_learning_rate: float = 1e-4
    learning_rate_end_factor: float = 0.5
    learning_rate_convergence_percentage: float = 0.75
    weight_decay: float = 5e-4
    accumulate_grad_batches: int = 1
    val_freq: int = 100
    num_batches_per_train_eval: int = 10
    num_batches_per_test_eval: int = -1
    skip_train_val: bool = False
    print_timers_freq: int = 1000
    print_progress_freq: int = 100
    save_checkpoint: bool = True
    # Validation-sampler cost knobs: DDIM-10 by default (None = full DDPM).
    eval_num_inference_steps: Optional[int] = 10
    eval_scheduler: str = "ddim"
    checkpoint_dir: str = "checkpoints"
    # "msgpack": best.ckpt / last.ckpt files (the port writes them with
    # torch.save, rank 0 only). "orbax": best/ and last/ directories written
    # asynchronously by every rank (training/orbax_checkpoint.py).
    checkpoint_backend: str = "msgpack"
    seed: int = 0
    set_epoch_every: int = 5
    # Activation recomputation in the train step: "none" keeps every
    # activation; any other value runs each (attention, feed-forward) layer
    # of the transformer stacks under torch.utils.checkpoint, recomputing it
    # in the backward pass. JAX's "dots" / "dots_no_batch" policies (keep
    # matmul outputs, recompute the rest) have no exact torch equivalent:
    # all three names recompute whole layers here.
    remat_policy: str = "none"


def make_train_batch_template(
    config: DiffuserActorConfig,
    batch_size: int = 2,
    n_vertices: int = 32,
    feature_dim: int = 8,
    image_size: int = 32,
    ncam: int = 1,
) -> Dict[str, Any]:
    """A zero batch (numpy) with the train batch's structure."""
    L, G, H = config.prediction_horizon, config.ngrippers, config.nhist
    batch: Dict[str, Any] = {
        "gripper_history": np.zeros((batch_size, H, G, 8), np.float32),
        "gt_gripper_pred": np.zeros((batch_size, L, G, 8), np.float32),
        "gt_head_yaw": (
            np.zeros((batch_size, L, 1), np.float32) if config.predict_head_yaw else None
        ),
        "instruction": None,
        "rgbs": None,
        "pcds": None,
        "pcd_valid_mask": None,
        "vertices": None,
        "vertex_features": None,
        "vertices_valid_mask": None,
        "is_keypose": None,
    }
    batch["gripper_history"][..., 3] = 1.0  # unit quaternions
    batch["gt_gripper_pred"][..., 3] = 1.0
    if config.data_type in ("mesh", "rgbd_and_mesh"):
        batch["vertices"] = np.zeros((batch_size, n_vertices, 3), np.float32)
        batch["vertex_features"] = np.zeros((batch_size, n_vertices, feature_dim), np.float16)
        batch["vertices_valid_mask"] = np.ones((batch_size, n_vertices), bool)
    if config.data_type in ("rgbd", "rgbd_and_mesh"):
        shape = (batch_size, ncam, image_size, image_size)
        batch["rgbs"] = np.zeros(shape + (3,), np.float32)
        batch["pcds"] = np.zeros(shape + (3,), np.float32)
        batch["pcd_valid_mask"] = np.ones(shape, bool)
    return batch


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence(parts).generate_state(1)[0])


class Trainer:
    """Trains a ``DiffuserActor`` on the process's device (default ``cuda``),
    one rank of a process group when there is one.

    ``init_state`` (or ``load_checkpoint``) builds ``self.model`` and
    ``self.optimizer``; the other methods work on them. ``batch_size`` is
    the global batch: each of the world's ranks trains on an equal share.
    """

    def __init__(
        self,
        model_config: DiffuserActorConfig,
        trainer_config: TrainerConfig,
        workspace_bounds,
        device: DeviceLike = None,
        metric_logger=None,
        backbone_weights: Optional[str] = None,
    ):
        if trainer_config.checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(f"Unknown checkpoint_backend {trainer_config.checkpoint_backend!r}; "
                             "expected 'msgpack' or 'orbax'")
        if trainer_config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {trainer_config.remat_policy!r}")
        self.model_config = model_config
        self.config = trainer_config
        # cuDNN's deterministic algorithms, for the process: a train step then
        # repeats bit for bit on the card, as the JAX package's XLA step does.
        # Without them the weight gradients of the CLIP FPN's convolutions sum
        # in a varying order, and Adam carries the last bits into the steps
        # that follow.
        torch.backends.cudnn.deterministic = True
        self.mesh = make_data_mesh(device)
        if trainer_config.batch_size % self.mesh.world_size:
            raise ValueError(f"batch_size {trainer_config.batch_size} does not split into "
                             f"{self.mesh.world_size} ranks")
        self.device = self.mesh.device
        self.workspace_bounds = torch.as_tensor(np.asarray(workspace_bounds, np.float32),
                                                device=self.device)
        self.metric_logger = metric_logger
        self.backbone_weights = backbone_weights
        self.model: Optional[DiffuserActor] = None
        self.optimizer: Optional[Optimizer] = None
        self._copy_stream = None
        self._orbax = None

    # --- setup ---------------------------------------------------------------
    def init_state(self, flax_params: Optional[Dict[str, Any]] = None
                   ) -> Tuple[DiffuserActor, Optimizer]:
        """Build the model from ``seed`` with the flax initialisers, or with
        a flax parameter tree through the weight bridge; then its optimizer.
        With ``backbone_weights`` (a converted ``.npz``) an image model's
        backbone is loaded from it."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.config.seed)
            model = DiffuserActor(self.model_config, device=self.device)
        if flax_params is not None:
            load_flax_params(model, flax_params)
        elif self.backbone_weights and self.model_config.data_type in ("rgbd", "rgbd_and_mesh"):
            from nvblox_mindmap_torch.models.pretrained import load_backbone_into_model

            load_backbone_into_model(model, self.model_config.feature_type,
                                     self.backbone_weights)
        set_layer_checkpointing(model, self.config.remat_policy != "none")
        cfg = self.config
        self.model = replicate(model, self.mesh)
        self.optimizer = Optimizer(
            model,
            initial_learning_rate=cfg.initial_learning_rate,
            weight_decay=cfg.weight_decay,
            end_factor=cfg.learning_rate_end_factor,
            total_iters=cfg.train_iters,
            convergence_percentage=cfg.learning_rate_convergence_percentage,
            accumulate_grad_batches=cfg.accumulate_grad_batches,
            # The frozen backbone (upstream semantics); CLIP's FPN trains.
            trainable_mask=frozen_feature_extractor_mask(model, fpn_trainable=True),
        )
        return model, self.optimizer

    def _generator(self, *parts: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(_seed(*parts))

    # --- steps ---------------------------------------------------------------
    def compute_loss_and_grads(self, batch: Dict[str, Any], step: int,
                               noise: Optional[torch.Tensor] = None,
                               timesteps: Optional[torch.Tensor] = None
                               ) -> Dict[str, torch.Tensor]:
        """Forward and backward of one (micro-)batch under eager attention;
        the gradients, averaged over the ranks, are left in the parameters'
        ``.grad``; returns the losses, averaged likewise. ``batch`` is the
        global batch (host arrays: the rank takes its rows) or the rank's
        part on the device. ``noise`` and ``timesteps`` are the global
        batch's; they default to draws seeded by (``seed``, ``step``)."""
        with span("trainer/loss_and_grads"):
            self.model.train()
            prepared = prepare_inputs(shard_batch(batch, self.mesh), self.workspace_bounds,
                                      self.model_config, device=self.device)
            gt = prepared["gt_gripper_pred"]
            if noise is None or timesteps is None:
                # diffusion_train_loss's draws, in its order, for the global batch.
                generator = self._generator(self.config.seed, step)
                shape = (gt.shape[0] * self.mesh.world_size,) + tuple(gt.shape[1:])
                if noise is None:
                    noise = torch.randn(shape, generator=generator, device=self.device,
                                        dtype=gt.dtype)
                if timesteps is None:
                    timesteps = torch.randint(0, self.model_config.diffusion_timesteps,
                                              shape[:1], generator=generator, device=self.device)
            noise, timesteps = (local_rows(torch.as_tensor(x, device=self.device), self.mesh)
                                for x in (noise, timesteps))
            losses = diffusion_train_loss(self.model, prepared, noise, timesteps, impl="eager")
            losses["total"].backward()
        return self._average_over_ranks({k: v.detach() for k, v in losses.items()})

    def _average_over_ranks(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The trainable gradients and ``losses`` averaged over the process
        group's ranks in place, in one all-reduce of one flat buffer (the
        frozen backbone has no gradient and is not in it). Without a process
        group there is nothing to do. The exchange is its own span, outside
        ``trainer/loss_and_grads``."""
        if not (dist.is_available() and dist.is_initialized()):
            return losses
        with span("trainer/all_reduce"):
            grads = [p.grad for p in self.optimizer.params if p.grad is not None]
            names = sorted(losses)
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [losses[k].reshape(1).to(torch.float32) for k in names])
            dist.all_reduce(flat)
            flat /= self.mesh.world_size
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            return {k: flat[offset + i] for i, k in enumerate(names)}

    def train_one_step(self, batch: Dict[str, Any], step: int,
                       noise: Optional[torch.Tensor] = None,
                       timesteps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One micro-batch: loss, backward and optimizer step (an update
        every ``accumulate_grad_batches`` calls). Returns the losses."""
        with span("trainer/step"):
            losses = self.compute_loss_and_grads(batch, step, noise, timesteps)
            with span("trainer/optimizer"):
                self.optimizer.step()
                self.optimizer.zero_grad()
        return losses

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                  init_noise: Optional[torch.Tensor] = None,
                  step_noise: Optional[torch.Tensor] = None):
        """One eval batch: (losses, metrics, predicted positions (B, L, G, 3),
        ground-truth positions), tensors on the device. The sampler's noise
        comes from ``init_noise`` / ``step_noise`` or ``generator``."""
        cfg = self.model_config
        self.model.eval()
        prepared = prepare_inputs(batch, self.workspace_bounds, cfg, device=self.device)
        kind = self.config.eval_scheduler
        traj, head_yaw, _ = sample_trajectory(
            self.model, prepared, None, num_inference_steps=self._eval_num_steps(),
            scheduler_kind=kind,
            stochastic=(kind == "ddpm"), normalized=True, init_noise=init_noise,
            step_noise=step_noise, generator=generator,
        )
        # The loss against the normalized ground truth trajectory.
        losses = compute_loss(
            traj, head_yaw, prepared["gt_gripper_pred"], prepared.get("gt_openness"),
            prepared.get("gt_head_yaw"), loss_weights=cfg.loss_weights,
            predict_head_yaw=cfg.predict_head_yaw, rotation_form="6D",
        )
        # The metrics on unnormalized quaternion actions.
        rot, quat = cfg.rotation_parametrization, cfg.quaternion_format
        pred = unnormalize_trajectory(traj, self.workspace_bounds, rot, quat)
        gt = torch.cat([unnormalize_trajectory(prepared["gt_gripper_pred"],
                                               self.workspace_bounds, rot, quat),
                        prepared["gt_openness"]], dim=-1)
        metrics = compute_metrics(pred, head_yaw, gt, prepared.get("gt_head_yaw"),
                                  predict_head_yaw=cfg.predict_head_yaw,
                                  rotation_form="quaternion")
        return losses, metrics, pred[..., :3], gt[..., :3]

    def _eval_num_steps(self) -> Optional[int]:
        n_steps = self.config.eval_num_inference_steps
        if n_steps is not None:
            # The sampler cannot take more steps than the train schedule has.
            n_steps = min(n_steps, self.model_config.diffusion_timesteps)
        return n_steps

    def _eval_noise(self, rows: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The sampler's noise for an eval batch of ``rows`` global rows,
        drawn from ``generator`` as ``sample_trajectory`` draws it; the
        rank's rows of it."""
        kind = self.config.eval_scheduler
        cfg = self.model_config
        steps = cfg.schedules(kind=kind)[0].timesteps(self._eval_num_steps()).shape[0]
        init_noise, step_noise = sampler_noise(cfg, rows, steps, kind == "ddpm", generator,
                                               self.device)
        noise = {"init_noise": local_rows(init_noise, self.mesh)}
        if step_noise is not None:
            noise["step_noise"] = local_rows(step_noise.transpose(0, 1),
                                             self.mesh).transpose(0, 1)
        return noise

    def evaluate_nsteps(self, loader, step: int, num_batches: int, split: str
                        ) -> Tuple[float, Dict[str, np.ndarray]]:
        """Run eval batches; returns (mean total loss, mean metrics), each
        batch weighted by its size.

        Under a process group each rank evaluates its rows of every batch,
        as the JAX trainer shards an eval batch over its mesh: the sampler's
        noise is drawn for the whole batch and each rank takes its rows, so
        n ranks give one process's numbers on batches that divide. A host
        batch that does not divide is trimmed to a multiple of the ranks (a
        warning says how many rows were dropped), one smaller than the
        ranks is skipped; a batch already on the device is the rank's part
        (a packed epoch's view, as in ``shard_batch``)."""
        n = len(loader) if num_batches == -1 else min(num_batches, len(loader))
        world = self.mesh.world_size
        loss_sum = 0.0
        metric_sums: Dict[str, np.ndarray] = {}
        count = 0
        figure_logged = False
        for i, batch in enumerate(loader):
            if i >= n:
                break
            bsz = batch["gripper_history"].shape[0]
            if all(v is None or on_mesh_device(v, self.mesh) for v in batch.values()):
                bsz *= world  # the rank's part: the global batch is the ranks' parts
            elif bsz % world:
                keep = bsz // world * world
                if keep == 0:
                    logger.warning("eval batch of %d samples < mesh size %d; skipped",
                                   bsz, world)
                    continue
                logger.warning("eval batch of %d samples trimmed to %d (mesh size %d): "
                               "%d tail samples dropped from the weighted val loss",
                               bsz, keep, world, bsz - keep)
                batch = {k: v[:keep] if getattr(v, "ndim", 0) > 0 and v.shape[0] == bsz else v
                         for k, v in batch.items()}
                bsz = keep
            generator = self._generator(self.config.seed + 17, step * 1000 + i)
            with Timer("step/eval/inference", synchronize=True):
                losses, metrics, pred_pos, gt_pos = self.eval_step(
                    shard_batch(batch, self.mesh), **self._eval_noise(bsz, generator))
                total = float(losses["total"])
                metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            if not figure_logged and self.metric_logger is not None and self.mesh.rank == 0:
                # The GT-vs-prediction figure of the first evaluated batch
                # (rank 0's rows).
                figure_logged = True
                try:
                    self.metric_logger.log_trajectory_figure(
                        pred_pos.cpu().numpy(), gt_pos.cpu().numpy(), step, split=split)
                except Exception as e:  # a figure must never stop training
                    logger.warning("trajectory figure failed: %s", e)
            loss_sum += total * bsz
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v * bsz
            count += bsz
        if count == 0:
            return float("inf"), {}
        # Across ranks: each holds the means of its equal share of every batch.
        mean_metrics = mean_metrics_across_processes(
            {"loss": loss_sum / count, **{k: v / count for k, v in metric_sums.items()}})
        mean_loss = float(mean_metrics.pop("loss"))
        if self.metric_logger is not None and self.mesh.rank == 0:
            self.metric_logger.log(mean_metrics, step, prefix=f"{split}/")
            self.metric_logger.log({"loss": mean_loss}, step, prefix=f"{split}/")
        logger.info("[%s] step %d: loss %.6f, distance %.6f m, rot err %.6f deg", split, step,
                    mean_loss, float(mean_metrics.get("distance_m", np.nan)),
                    float(mean_metrics.get("rot_error_deg", np.nan)))
        return mean_loss, mean_metrics

    # --- the loop ------------------------------------------------------------
    def _to_device(self, batch: Dict[str, Any]):
        """Start the rank's part of a batch on its way to the device: (device
        batch, the copy's event). On CUDA a host batch is copied from pinned
        memory on a side stream, so it overlaps the step in flight; a batch
        already on the device (a packed epoch's views) is not copied."""
        if self.device.type != "cuda" or all(v is None or on_mesh_device(v, self.mesh)
                                             for v in batch.values()):
            return shard_batch(batch, self.mesh), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = shard_batch(batch, self.mesh)
        event = torch.cuda.Event()
        event.record(self._copy_stream)
        return out, event

    def _ready(self, copied) -> Dict[str, Any]:
        """The batch of ``_to_device``, usable on the current stream."""
        batch, event = copied
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                if v is not None:
                    v.record_stream(stream)
        return batch

    def run_training(
        self,
        train_loader,
        validation_loader,
        start_iter: int = 0,
        best_loss: Optional[float] = None,
        args_dict: Optional[Dict] = None,
    ) -> Optional[float]:
        """Iteration-based training loop; returns the best validation loss.

        ``train_loader`` iterates host batches (dicts of numpy arrays) or the
        rank's batches on the device, has a length, and may carry a
        ``sampler`` with ``set_epoch`` or take ``set_epoch`` itself.
        """
        cfg = self.config
        if self.model is None:
            self.init_state()
        train_epoch_length = len(train_loader)
        if train_epoch_length <= 0:
            raise ValueError("Train loader contains less than one batch.")
        sampler = getattr(train_loader, "sampler", None)
        train_iter = None
        next_batch = None
        step = start_iter
        while step < cfg.train_iters:
            epoch_idx = step // train_epoch_length
            if step % train_epoch_length == 0 or train_iter is None:
                if sampler is not None:
                    # The stream reseeds once per set_epoch_every block; the
                    # block's base epoch also restores it on a resume.
                    sampler.set_epoch((epoch_idx // cfg.set_epoch_every) * cfg.set_epoch_every)
                elif hasattr(train_loader, "set_epoch"):
                    # A packed epoch's loader: its shuffle is pinned to the
                    # absolute epoch, so a resume continues its orders.
                    train_loader.set_epoch(epoch_idx)
                train_iter = iter(train_loader)
                next_batch = None
            step_timer = Timer("step")
            with Timer("step/load_batch"):
                if next_batch is None:
                    try:
                        next_batch = self._to_device(next(train_iter))
                    except StopIteration:
                        train_iter = iter(train_loader)
                        next_batch = self._to_device(next(train_iter))
                device_batch = next_batch
                try:
                    next_batch = self._to_device(next(train_iter))
                except StopIteration:
                    next_batch = None
            with Timer("step/train", synchronize=True):
                losses = self.train_one_step(self._ready(device_batch), step)
            if ((step + 1) % cfg.val_freq == 0 and self.metric_logger is not None
                    and self.mesh.rank == 0):
                self.metric_logger.log({f"train-loss/{k}": float(v) for k, v in losses.items()},
                                       step)
            if step % cfg.print_progress_freq == 0:
                logger.info("step %d/%d (epoch %d): total %.6f pos %.6f rot %.6f grip %.6f",
                            step, cfg.train_iters, epoch_idx, float(losses["total"]),
                            float(losses["pos"]), float(losses["rot"]),
                            float(losses["gripper"]))
            if (step + 1) % cfg.val_freq == 0:
                if not cfg.skip_train_val:
                    self.evaluate_nsteps(train_loader, step, cfg.num_batches_per_train_eval,
                                         split="train-val")
                new_loss, _ = self.evaluate_nsteps(validation_loader, step,
                                                   cfg.num_batches_per_test_eval, split="val")
                if cfg.save_checkpoint:
                    # The asynchronous save is collective: every rank enters
                    # it. The msgpack files are rank 0's.
                    if cfg.checkpoint_backend == "orbax" or self.mesh.rank == 0:
                        best_loss = self._save_best_and_last(step, new_loss, best_loss)
                    if args_dict is not None and self.mesh.rank == 0:
                        save_training_args(cfg.checkpoint_dir, args_dict)
            step_timer.stop()
            if step % cfg.print_timers_freq == 0 and step > 0:
                logger.info("\n%s", timer_status_string())
            step += 1
        if self._orbax is not None:
            self._orbax.wait()
        return best_loss

    def _save_best_and_last(self, step: int, new_loss: Optional[float],
                            best_loss: Optional[float]) -> Optional[float]:
        """Write last, and best when ``new_loss`` improves, through the
        configured backend; returns the running best."""
        cfg = self.config
        if cfg.checkpoint_backend == "orbax":
            if self._orbax is None:
                from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer

                self._orbax = OrbaxCheckpointer(cfg.checkpoint_dir)
            return self._orbax.save_best_and_last(self.model.state_dict(),
                                                  self.optimizer.tensor_state(), step,
                                                  new_loss, best_loss)
        return save_checkpoint(cfg.checkpoint_dir, self.model.state_dict(),
                               self.optimizer.state_dict(), step, new_loss, best_loss)

    def load_checkpoint(self, path: str) -> Tuple[int, Optional[float]]:
        """Build the model and optimizer from a checkpoint; returns (iter,
        best_loss). A port checkpoint (a ``.ckpt`` file, or a ``best/`` /
        ``last/`` directory of the asynchronous backend) restores both. A
        JAX package checkpoint (a ``.ckpt`` file, or a ``best/`` / ``last/``
        directory of its orbax backend) gives its parameters (through the
        weight bridge), iter, best_loss and its optax state: the Adam
        moments, the schedule's update count and a pending accumulation. A
        file whose optax state is empty (``None``) starts the optimizer
        afresh, and says so."""
        if os.path.isdir(path):
            from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer

            self.init_state()
            path = path.rstrip("/")
            ckptr = OrbaxCheckpointer(os.path.dirname(path), async_write=False)
            _, opt_state, step, best_loss = ckptr.restore(
                os.path.basename(path), self.model.state_dict(), self.optimizer.tensor_state())
            self.optimizer.load_tensor_state(opt_state)
            return step, best_loss
        if is_jax_checkpoint(path):
            params, step, best_loss = read_jax_checkpoint(path)
            self.init_state(flax_params=params)
            opt_state = read_jax_opt_state(path)
            if opt_state is None:
                logger.info("%s holds no optimizer state: the optimizer starts afresh "
                            "(update count 0, empty Adam moments)", path)
            else:
                self.optimizer.load_optax_state(opt_state)
            return step, best_loss
        self.init_state()
        payload = load_checkpoint_file(path)
        self.model.load_state_dict(payload["state_dict"])
        self.optimizer.load_state_dict(payload["optimizer"])
        return payload["iter"], payload["best_loss"]
