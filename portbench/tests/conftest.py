"""Shared helpers of the benchmark's tests: the cells at a tiny size on the
CPU, through the plain paths (the flash wrapper's plain version)."""
import time

import pytest
import torch

SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's seeds are


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to seconds on the CPU: 64x64 frames,
    64 vertices, 4 cm voxels, 4 frames, a 2-row batch."""
    clip = cell.startswith("clip")
    traffic = {"frames": 4, "noise_bank": 64, "warmup_least": 1, "warmup_most": 2,
               "trace_units": 3, "compare_goals": 2, "batch": 2, "batches": 2}
    if cell.endswith("_loop"):
        traffic["steps_per_goal"] = 1  # a goal after every step: one in any window
    return {"config": {"image_size": 64, "num_vertices_to_sample": 64,
                       "model": {"feature_image_size": [8, 8] if clip else [4, 4]},
                       "mapping": {"voxel_size_m": 0.04, "max_feature_pages": 96}},
            "traffic": traffic}


def run_tiny(cell: str, trace: bool = False, seconds: float = 1.0, seed: int = SEED) -> dict:
    from portbench import harness

    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), tiny(cell))


@pytest.fixture
def card():
    """The CUDA device, for tests marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
