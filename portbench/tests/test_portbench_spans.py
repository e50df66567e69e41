"""The readers of the program's spans, from a hand-made Chrome trace: two
goals, a sim step and a train step, with launches tied to device
operations by correlation id and two waits under the first goal; and the
split of a traced window's idle time by the innermost span."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, idle, spans

READERS = ("sampler_step_ms.goal", "sampler_step_launches.goal", "encode_ms.goal",
           "policy_self_ms.goal", "goal_syncs.goal", "pool_update_ms.loop",
           "step_launches.loop", "optimizer_ms.train")


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "mindmap/" + name, "ts": ts,
            "dur": dur, "tid": 1}


def _runtime(name, ts, corr=None):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 0.5, "tid": 1,
            "args": {} if corr is None else {"correlation": corr}}


def _op(cat, corr, ts, dur):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _trace():
    return [
        # Goal 1, [0, 100]: mesh 20, predict 50 (encode 18, two denoiser steps of 10).
        _span("policy/goal", 0, 100),
        _span("policy/goal/mesh", 5, 20),
        _span("policy/goal/sample_vertices", 26, 4),
        _span("policy/goal/predict", 40, 50),
        _span("model/prepare_inputs", 40, 2),
        _span("model/encode", 42, 18),
        _span("sampler/step", 60, 10),
        _span("sampler/step", 70, 10),
        _runtime("cudaLaunchKernel", 10, corr=5),
        _runtime("cudaLaunchKernel", 61, corr=1),
        _runtime("cudaLaunchKernel", 63, corr=2),
        _runtime("cudaLaunchKernel", 65, corr=3),
        _runtime("cudaMemcpyAsync", 71, corr=4),
        _runtime("cudaDeviceSynchronize", 31),
        _runtime("cudaStreamSynchronize", 85),
        _op("kernel", 5, 12, 3),
        _op("kernel", 1, 62, 2),
        _op("kernel", 2, 64, 2),
        _op("kernel", 3, 66, 2),
        _op("gpu_memcpy", 4, 72, 1),
        # Goal 2, [1000, 1040]: mesh 10, predict 20 (encode 10), one wait.
        _span("policy/goal", 1000, 40),
        _span("policy/goal/mesh", 1000, 10),
        _span("policy/goal/predict", 1010, 20),
        _span("model/encode", 1010, 10),
        _runtime("cudaMemcpy", 1035),
        # A sim step, [200, 260]: the feature-pool update launches two
        # operations that overlap over [305, 310].
        _span("policy/step", 200, 60),
        _span("mapper/decay", 201, 4),
        _span("policy/step/features", 206, 14),
        _span("policy/step/integrate", 221, 38),
        _span("mapper/depth", 222, 8),
        _span("mapper/color", 231, 9),
        _span("mapper/features", 241, 17),
        _runtime("cudaLaunchKernel", 202, corr=6),
        _runtime("cudaLaunchKernel", 207, corr=7),
        _runtime("cudaLaunchKernel", 223, corr=8),
        _runtime("cudaLaunchKernel", 242, corr=9),
        _runtime("cudaLaunchKernel", 243, corr=10),
        _op("kernel", 6, 210, 5),
        _op("kernel", 7, 220, 5),
        _op("kernel", 8, 240, 5),
        _op("kernel", 9, 300, 10),
        _op("kernel", 10, 305, 7),
        # A train step, [400, 500]: its encoder pass is no goal's; the
        # optimizer launches two operations of 4 and 6.
        _span("trainer/step", 400, 100),
        _span("trainer/loss_and_grads", 400, 70),
        _span("model/encode", 410, 10),
        _span("trainer/optimizer", 471, 28),
        _runtime("cudaLaunchKernel", 472, corr=11),
        _runtime("cudaLaunchKernel", 480, corr=12),
        _runtime("cudaStreamSynchronize", 490),
        _op("kernel", 11, 520, 4),
        _op("kernel", 12, 530, 6),
        # The device's own projection of a span is not a host span.
        {"ph": "X", "cat": "gpu_user_annotation", "name": "mindmap/sampler/step", "ts": 62,
         "dur": 40, "tid": 7},
    ]


def _run(device="cuda", events=True):
    return SimpleNamespace(events=_trace() if events else None, device=torch.device(device))


@pytest.mark.parametrize("name,value", [
    ("sampler_step_ms.goal", 0.010),  # two steps of 10 us
    ("sampler_step_launches.goal", 2.0),  # four operations over two steps
    ("encode_ms.goal", 0.014),  # (18 + 10) / 2 goals; the train step's is no goal's
    ("policy_self_ms.goal", 0.020),  # (100 - 20 - 50 + 40 - 10 - 20) / 2
    ("goal_syncs.goal", 1.0),  # a stream sync and a sync copy; not the device sync
    ("pool_update_ms.loop", 0.012),  # the union of [300, 310] and [305, 312]
    ("step_launches.loop", 5.0),
    ("optimizer_ms.train", 0.010),
])
def test_reader_values(name, value):
    assert harness.load_metric(name).read(_run()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_off_the_card_or_without_spans(name):
    reader = harness.load_metric(name)
    assert reader.read(_run(device="cpu")) is None
    assert reader.read(_run(events=False)) is None
    # A program without the spans (an earlier commit's) reads nothing and raises nothing.
    bare = SimpleNamespace(events=[e for e in _trace() if e["cat"] != "user_annotation"],
                           device=torch.device("cuda"))
    assert reader.read(bare) is None


def test_every_reader_has_an_entry():
    entries = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"], name


def test_idle_split_names_each_gap_by_the_innermost_span():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": idle.WINDOW, "ts": 0, "dur": 100},
        _span("policy/goal", 10, 80),
        _span("sampler/step", 20, 20),
        _span("sampler/step", 50, 10),
        _span("policy/step", 95, 30),  # runs past the window's end
        _op("kernel", 1, 0, 5),
        _op("kernel", 2, 25, 5),
        _op("gpu_memcpy", 3, 85, 10),
        _op("kernel", 4, 120, 5),  # after the window
        # The device's own projection of a span is not a host span.
        {"ph": "X", "cat": "gpu_user_annotation", "name": "mindmap/sampler/step", "ts": 0,
         "dur": 100, "tid": 7},
    ]
    split = spans.idle_split(events)
    # Idle: [5, 25], [30, 85], [95, 100] in us.
    assert split == pytest.approx({spans.OUTSIDE: 5e-6, "policy/goal": 45e-6,
                                   "sampler/step": 25e-6, "policy/step": 5e-6})
    busy, length = idle.busy_and_window_s(events)
    assert sum(split.values()) == pytest.approx(length - busy)
