"""The control of every cell comes out not correct on the card: the plain
reference in the control's arithmetic (each precision the configuration
states lowered one step: TF32 for float32 with TF32 off, float8 for the
ViT's bfloat16 and the pool's float16) put in the program's place fails at
least one of the cell's limits, on three seeds at the cell's own size,
while the program passes them. Runs on the chip:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda

The CPU tests show that the control's arithmetic reaches each stage whose
precision a configuration states.
"""
import pytest
import torch

from portbench import calibrate, harness
from portbench.reference import precision

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    for seed in SEEDS:
        out = calibrate.readings(cell, seed, 3.0, True, card)
        limits = out["limits"]
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        assert any(out["control"][k] > v for k, v in limits.items() if k in out["control"]), out
        for fault in out.get("faults", {}).values():
            assert any(fault[k] > v for k, v in limits.items() if k in fault), out


def test_control_lowers_the_clip_convolutions_to_tf32():
    from portbench.reference.models.clip_resnet_fpn import fp32_convolutions

    for lowered in (False, True):
        with precision.arithmetic(lowered), fp32_convolutions():
            assert torch.backends.cudnn.allow_tf32 is lowered
            assert torch.backends.cuda.matmul.allow_tf32 is lowered


def test_control_rounds_the_vit_and_the_pool_to_float8():
    from portbench.reference.models.feature_extractors import VitFeatureExtractor

    torch.manual_seed(0)
    vit = VitFeatureExtractor(patch_size=4, width=32, depth=2, num_heads=4,
                              feature_image_size=(4, 4))
    rgb = torch.rand(1, 16, 16, 3)
    plain = vit(rgb)
    with precision.arithmetic(True):
        low = vit(rgb)
        pool = torch.randn(64, dtype=torch.float16)
        rounded = precision.fp8(pool)
    assert torch.equal(vit(rgb), plain)
    assert 1e-3 < (low - plain).abs().max() < 1.0
    assert rounded.dtype == torch.float16 and not torch.equal(rounded, pool)
    assert torch.allclose(rounded, pool, rtol=0.07, atol=float(pool.abs().max()) / 448)
    assert torch.equal(precision.fp8(pool), pool)
