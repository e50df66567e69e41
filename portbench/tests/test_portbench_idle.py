"""The idle share and the breakdown from a synthetic Chrome trace with
overlapping kernels."""
import json

import pytest

from portbench import idle


def _trace():
    X = "X"
    return [
        {"ph": X, "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "portbench.fps", "ts": 5, "dur": 20},
        {"ph": X, "cat": "user_annotation", "name": "portbench.mesh", "ts": 60, "dur": 30},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 1,
         "args": {"correlation": 3}},
        # Two kernels on two streams overlap over [15, 20].
        {"ph": X, "cat": "kernel", "name": "a", "ts": 10, "dur": 10, "args": {"correlation": 1}},
        {"ph": X, "cat": "kernel", "name": "b", "ts": 15, "dur": 10, "args": {"correlation": 2}},
        {"ph": X, "cat": "gpu_memcpy", "name": "copy", "ts": 40, "dur": 5,
         "args": {"correlation": 3}},
        # Outside the window: not counted.
        {"ph": X, "cat": "kernel", "name": "late", "ts": 150, "dur": 10},
    ]


def test_busy_is_the_union_of_overlapping_operations():
    events = _trace()
    busy, length = idle.busy_and_window_s(events)
    assert busy == pytest.approx((15 + 5) / 1e6)
    assert length == pytest.approx(100 / 1e6)
    assert idle.idle_share(events) == pytest.approx(0.8)


def test_device_time_under_a_host_range():
    events = _trace()
    assert idle.range_device_s(events, "portbench.fps") == pytest.approx(15 / 1e6)
    assert idle.range_device_s(events, "portbench.sampler") is None


def test_breakdown_names_ops_and_gaps(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace() + [{"ph": "i", "name": "marker"}]}))
    events = idle.load(str(path))
    out = idle.breakdown(events)
    assert out["device_ops"] == [["a", pytest.approx(1e-5)], ["b", pytest.approx(1e-5)],
                                 ["copy", pytest.approx(5e-6)]]
    # Gaps: [0, 10] (middle 5, in fps), [25, 40] (outside every span), [45, 100]
    # (middle 72.5, in mesh).
    assert out["idle_gaps"] == [["mesh", pytest.approx(55e-6)],
                                ["window", pytest.approx(15e-6)],
                                ["fps", pytest.approx(10e-6)]]
