"""Cluster workflow generation (reference: mindmap_osmo/*).

Port of ``nvblox_mindmap_tpu/workflows/submit.py``. The reference submits
datagen / training / evaluation / end-to-end pipelines to NVIDIA's OSMO
batch system with per-stage GPU, memory and storage tables. This module
emits scheduler-agnostic batch specs (JSON with the command line of each
stage) describing the command, the host resources, the stage's GPUs and the
artifact flow between stages, for any scheduler (Slurm, Kubernetes jobs,
plain ssh).

Stages and defaults follow the reference's resource inference
(mindmap_osmo/workflow_utils/workflow_constants.py:22-73): evaluation and
datagen get 1 GPU, training 2, plus memory and storage floors. The commands
run the port's apps; a training stage of more than one GPU launches one
process per GPU through ``torch.distributed.run`` (the app joins the
process group it describes).
"""
from __future__ import annotations

import dataclasses
import json
import shlex
from typing import Dict, List, Optional

STAGE_RESOURCES = {
    # GPUs, host memory GiB, scratch GiB
    "datagen": {"gpus": 1, "memory_gib": 64, "storage_gib": 256},
    "training": {"gpus": 2, "memory_gib": 128, "storage_gib": 512},
    "evaluation": {"gpus": 1, "memory_gib": 64, "storage_gib": 128},
}

STAGE_MODULES = {
    "datagen": "nvblox_mindmap_torch.apps.run_datagen",
    "training": "nvblox_mindmap_torch.apps.run_training",
    "evaluation": "nvblox_mindmap_torch.apps.run_closed_loop_policy",
}


@dataclasses.dataclass
class WorkflowStage:
    name: str
    kind: str  # datagen | training | evaluation
    args: List[str]
    depends_on: List[str] = dataclasses.field(default_factory=list)
    gpus: Optional[int] = None

    def to_spec(self) -> Dict:
        resources = dict(STAGE_RESOURCES[self.kind])
        if self.gpus is not None:
            resources["gpus"] = self.gpus
        launcher = ["python", "-m"]
        if self.kind == "training" and resources["gpus"] > 1:
            launcher += ["torch.distributed.run", "--standalone", "--nproc_per_node",
                         str(resources["gpus"]), "-m"]
        command = [*launcher, STAGE_MODULES[self.kind], *self.args]
        return {
            "name": self.name,
            "kind": self.kind,
            "command": command,
            "command_line": " ".join(shlex.quote(c) for c in command),
            "resources": resources,
            "depends_on": self.depends_on,
        }


def make_datagen_workflow(task: str, hdf5_file: str, output_dir: str,
                          demos: str = "0", extra_args: List[str] = ()) -> Dict:
    stage = WorkflowStage(
        name=f"datagen-{task}",
        kind="datagen",
        args=["--task", task, "--hdf5_file", hdf5_file, "--output_dir", output_dir,
              "--demos_datagen", demos, *extra_args],
    )
    return {"stages": [stage.to_spec()]}


def make_training_workflow(task: str, dataset: str, demos_train: str,
                           extra_args: List[str] = ()) -> Dict:
    stage = WorkflowStage(
        name=f"training-{task}",
        kind="training",
        args=["--task", task, "--dataset", dataset, "--demos_train", demos_train,
              *extra_args],
    )
    return {"stages": [stage.to_spec()]}


def make_evaluation_workflow(task: str, dataset: str, checkpoint: str,
                             demos: str = "0", extra_args: List[str] = ()) -> Dict:
    stage = WorkflowStage(
        name=f"evaluation-{task}",
        kind="evaluation",
        args=["--task", task, "--dataset", dataset, "--checkpoint", checkpoint,
              "--demos_closed_loop", demos, *extra_args],
    )
    return {"stages": [stage.to_spec()]}


def make_train_and_eval_workflow(task: str, dataset: str, demos_train: str,
                                 demos_eval: str, checkpoint_dir: str) -> Dict:
    train = WorkflowStage(
        name=f"training-{task}",
        kind="training",
        args=["--task", task, "--dataset", dataset, "--demos_train", demos_train,
              "--base_log_dir", checkpoint_dir],
    )
    evaluation = WorkflowStage(
        name=f"evaluation-{task}",
        kind="evaluation",
        args=["--task", task, "--dataset", dataset,
              "--checkpoint", f"{checkpoint_dir}/checkpoints/latest/best.ckpt",
              "--demos_closed_loop", demos_eval],
        depends_on=[train.name],
    )
    return {"stages": [train.to_spec(), evaluation.to_spec()]}


def make_e2e_workflow(task: str, hdf5_file: str, workdir: str,
                      demos: str = "0") -> Dict:
    """datagen -> training -> evaluation, chained by artifact paths."""
    datagen = WorkflowStage(
        name=f"datagen-{task}",
        kind="datagen",
        args=["--task", task, "--hdf5_file", hdf5_file,
              "--output_dir", f"{workdir}/dataset", "--demos_datagen", demos],
    )
    train = WorkflowStage(
        name=f"training-{task}",
        kind="training",
        args=["--task", task, "--dataset", f"{workdir}/dataset",
              "--demos_train", demos, "--base_log_dir", f"{workdir}/train"],
        depends_on=[datagen.name],
    )
    evaluation = WorkflowStage(
        name=f"evaluation-{task}",
        kind="evaluation",
        args=["--task", task, "--dataset", f"{workdir}/dataset",
              "--checkpoint", f"{workdir}/train/checkpoints/latest/best.ckpt",
              "--demos_closed_loop", demos],
        depends_on=[train.name],
    )
    return {"stages": [datagen.to_spec(), train.to_spec(), evaluation.to_spec()]}


def write_workflow(workflow: Dict, path: str):
    with open(path, "w") as f:
        json.dump(workflow, f, indent=2)
    return path
