"""The readers of the prediction cell's language span and encoder counters:
``language_ms.goal`` from a hand-made Chrome trace (two goals, each an
``encoder/language`` span whose launches run a linear layer and two flash
kernels, and one launch outside it), ``context_tokens.goal`` and
``fps_kept.goal`` from the counters a driver keeps; each gives nothing
where the run holds nothing to read (an earlier commit's program)."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness

COUNTER_READERS = {"context_tokens.goal": "context_tokens", "fps_kept.goal": "fps_kept"}


def _event(cat, name, ts, dur, corr=None, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {} if corr is None else {"correlation": corr}}


def _goal(t0, corr):
    """A goal at ``t0``: the language span (launches of a 5 us gemm and two
    flash tile kernels of 10 and 20 us, the second overlapping the first by
    4 us), then FPS (8 us) launched after the span."""
    return [
        _event("user_annotation", "mindmap/encoder/language", t0, 10),
        _event("cuda_runtime", "cudaLaunchKernel", t0 + 1, 1, corr),
        _event("kernel", "sm90_xmma_gemm_f32f32", t0 + 20, 5, corr, 7),
        _event("cuda_runtime", "cudaLaunchKernel", t0 + 3, 1, corr + 1),
        _event("kernel", "void flash_tile_kernel<16, 2, true>(Params)", t0 + 30, 10, corr + 1, 7),
        _event("cuda_runtime", "cudaLaunchKernel", t0 + 5, 1, corr + 2),
        _event("kernel", "void flash_tile_kernel<16, 2, true>(Params)", t0 + 36, 20, corr + 2, 7),
        _event("cuda_runtime", "cudaLaunchKernel", t0 + 12, 1, corr + 3),
        _event("kernel", "fps_kernel", t0 + 60, 8, corr + 3, 7),
    ]


def _run(device="cuda", events=True, counters=True):
    run = SimpleNamespace(events=(_goal(0, 1) + _goal(1000, 5)) if events else None,
                          device=torch.device(device))
    if counters:
        run.counters = {"context_tokens": [4096, 4096, 4096], "fps_kept": [819, 819, 819]}
    return run


def test_language_ms_reads_the_device_time_under_the_span():
    # 5 us, then 10 and 20 us overlapping by 4: 31 us a goal.
    assert harness.load_metric("language_ms.goal").read(_run()) == pytest.approx(0.031)


def test_language_ms_gives_nothing_off_the_card_or_without_the_span():
    reader = harness.load_metric("language_ms.goal")
    assert reader.read(_run(device="cpu")) is None
    assert reader.read(_run(events=False)) is None
    bare = _run()
    bare.events = [e for e in bare.events if e["cat"] != "user_annotation"]
    assert reader.read(bare) is None


@pytest.mark.parametrize("name,value", [("context_tokens.goal", 4096.0),
                                        ("fps_kept.goal", 819.0)])
def test_counter_readers_give_the_mean(name, value):
    assert harness.load_metric(name).read(_run()) == value


@pytest.mark.parametrize("name", sorted(COUNTER_READERS))
def test_counter_readers_give_nothing_without_the_counter(name):
    reader = harness.load_metric(name)
    assert reader.read(_run(counters=False)) is None
    run = _run()
    run.counters = {}
    assert reader.read(run) is None
    run.counters = {COUNTER_READERS[name]: []}
    assert reader.read(run) is None


@pytest.mark.parametrize("name", ["language_ms.goal", *sorted(COUNTER_READERS)])
def test_every_reader_has_an_entry(name):
    entries = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert entries[name]["workloads"] == ["peract_goal_ddpm100"]
    assert entries[name]["layer"] == "models.encoder"
