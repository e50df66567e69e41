"""The readers of the denoiser loop's CUDA graph replays, from a hand-made
Chrome trace: two goals, each an eager flash call of the encoder and one
``sampler/graph`` span whose graph launch runs two flash kernels and a
copy; and the flash roofline that counts the replayed calls, with the
program's count of them and without it (an earlier commit's program)."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, roofline

READERS = ("sampler_graph_ms.goal", "sampler_graph_launches.goal",
           "sampler_graph_device_ms.goal", "flash_roofline.goal_all")
SPLIT = (1, 8, 1, 3072, 24)  # B, H, L, S, D of an unmasked split call
TILE = (1, 8, 615, 615, 24)  # a tile call with 600 valid keys


def _event(cat, name, ts, dur, corr=None, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {} if corr is None else {"correlation": corr}}


def _goal(t0, corr):
    """A goal at ``t0``: the encoder's split call (10 us), then a replay
    whose launch runs a split (20 us), a tile (30 us) and a copy."""
    return [
        _event("cuda_runtime", "cudaLaunchKernel", t0 + 1, 1, corr),
        _event("kernel", "void flash_split_kernel<64, false>(Params)", t0 + 2, 10, corr, 7),
        _event("user_annotation", "mindmap/sampler/graph", t0 + 20, 8),
        _event("cuda_runtime", "cudaGraphLaunch", t0 + 25, 2, corr + 1),
        _event("kernel", "void flash_split_kernel<64, false>(Params)", t0 + 26, 20, corr + 1, 7),
        _event("kernel", "void flash_tile_kernel<64, 2, false>(Params)", t0 + 46, 30,
               corr + 1, 7),
        _event("gpu_memcpy", "Memcpy DtoD", t0 + 80, 4, corr + 1, 7),
    ]


def _run(device="cuda", events=True):
    B, H, L, S, D = SPLIT
    return SimpleNamespace(events=(_goal(0, 1) + _goal(1000, 3)) if events else None,
                           device=torch.device(device),
                           flash_calls=[(B, H, L, D, S, 4, None, False)] * 2,
                           flash_bound_s=2 * roofline.attention_bound_s(B, H, L, S, D, 4))


@pytest.fixture
def replayed(monkeypatch):
    """The program's count of replayed calls: both goals' replays, and a
    warm-up replay before the trace."""
    from nvblox_mindmap_torch.ops import flash_attention as fa

    counted = {
        fa.KernelCall("flash_attention_split", SPLIT[:3] + SPLIT[4:], SPLIT[3], 4, None): 3,
        fa.KernelCall("flash_attention_tile", TILE[:3] + TILE[4:], TILE[3], 4, 600): 3,
    }
    monkeypatch.setattr(fa, "REPLAYED", counted, raising=False)


@pytest.mark.parametrize("name,value", [
    ("sampler_graph_ms.goal", 0.008),
    ("sampler_graph_launches.goal", 3.0),
    ("sampler_graph_device_ms.goal", 0.054),  # 20 + 30 + 4 us
])
def test_replay_readers(name, value):
    assert harness.load_metric(name).read(_run()) == pytest.approx(value)


def test_flash_roofline_counts_the_replayed_calls(replayed):
    B, H, L, S, D = SPLIT
    split = roofline.attention_bound_s(B, H, L, S, D, 4)
    B, H, L, S, D = TILE
    tile = roofline.attention_bound_s(B, H, L, S, D, 4, 600, masked=True)
    device_s = 2 * (10 + 20 + 30) / 1e6
    got = harness.load_metric("flash_roofline.goal_all").read(_run())
    assert got == pytest.approx(100.0 * (2 * split + 2 * split + 2 * tile) / device_s)


def test_flash_roofline_without_replays_reads_as_the_eager_share(monkeypatch):
    """A program without ``REPLAYED`` and a trace without replays: the same
    share as ``flash_roofline.goal``."""
    from nvblox_mindmap_torch.ops import flash_attention as fa

    monkeypatch.delattr(fa, "REPLAYED", raising=False)
    run = _run()
    run.events = [e for e in run.events if e["args"].get("correlation") in (1, 3)]
    assert (harness.load_metric("flash_roofline.goal_all").read(run)
            == harness.load_metric("flash_roofline.goal").read(run))


def test_flash_roofline_gives_nothing_for_a_replay_it_cannot_bound(monkeypatch):
    from nvblox_mindmap_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "REPLAYED", {}, raising=False)
    assert harness.load_metric("flash_roofline.goal_all").read(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_off_the_card_or_without_spans(name, replayed):
    reader = harness.load_metric(name)
    assert reader.read(_run(device="cpu")) is None
    assert reader.read(_run(events=False)) is None
    if name != "flash_roofline.goal_all":
        bare = _run()
        bare.events = [e for e in bare.events if e["cat"] != "user_annotation"]
        assert reader.read(bare) is None


def test_every_reader_has_an_entry():
    entries = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["radio_goal"], name
