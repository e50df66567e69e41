"""The attention bound does not depend on the kernel that serves a call,
and counts only the valid keys."""
import torch

from portbench import roofline
from portbench.drivers import closed_loop


class _Run:
    profiling = True

    def __init__(self):
        self.flash_calls = []


def _bound(call):
    B, H, L, D, S, size, valid, masked = call
    return roofline.attention_bound_s(B, H, L, S, D, size,
                                      None if valid is None else int(valid), masked)


def test_bound_is_the_same_whichever_kernel_serves_the_call():
    from nvblox_mindmap_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    B, H, S, D = 2, 8, 300, 15
    for L in (1, 3, 8, 9, 615):
        q = torch.randn(B, H, L, D, generator=gen)
        k, v = (torch.randn(B, H, S, D, generator=gen) for _ in range(2))
        mask = torch.rand(B, S, generator=gen) > 0.3
        bounds = []
        for kernel in fa.KERNELS:
            run = _Run()
            recorded = closed_loop.flash_recorder(
                run, lambda name, q, k, v, m=None: fa.flash_attention_reference(q, k, v, m))
            out = recorded(kernel, q, k, v, mask)
            torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v, mask))
            bounds.append(_bound(run.flash_calls[0]))
        plain = roofline.attention_bound_s(B, H, L, S, D, 4, int(mask.sum()), masked=True)
        assert bounds == [plain, plain]


def test_bound_counts_only_valid_keys():
    # Large enough to be bound by operations at 989 TFLOP/s and 3.35 TB/s.
    B, H, L, S, D = 1, 8, 4096, 4096, 64
    full = roofline.attention_bound_s(B, H, L, S, D, 4, valid_keys=B * S, masked=True)
    half = roofline.attention_bound_s(B, H, L, S, D, 4, valid_keys=B * S // 2, masked=True)
    assert full == 4.0 * H * L * D * B * S / roofline.PEAK_FLOPS
    assert half == full / 2
    # Bound by bytes, masking does not lower the bound below the bytes.
    small = roofline.attention_bound_s(1, 8, 1, 3072, 15, 4, valid_keys=10, masked=True)
    assert small == (4 * (2 * 8 * 15 + 2 * 8 * 3072 * 15) + 3072) / roofline.PEAK_BYTES_PER_S


def test_peak_share():
    assert roofline.peak_share_percent(roofline.PEAK_FLOPS, 1.0) == 100.0
    assert roofline.count_flops(lambda: torch.ones(4, 8) @ torch.ones(8, 16)) == 2 * 4 * 8 * 16
