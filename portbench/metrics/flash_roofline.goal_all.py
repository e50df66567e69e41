"""The flash attention calls' share of their roofline in the traced goals,
CUDA graph replays included: ``flash_roofline.goal``'s share (each call's
``roofline.attention_bound_s`` summed, over the flash kernels' device time
in the trace), whose recorder wraps ``run_kernel`` and so sees only the
calls launched eagerly. A replay launches its calls without that function;
the program counts them by call in ``flash_attention.REPLAYED``, a masked
call with the valid keys of its capture's mask. Each flash kernel launched
inside a ``sampler/graph`` span of the trace takes the mean bound of that
kernel's replayed calls: exact where every replay is of one graph and its
masks keep their valid keys, as in a cell whose goals share one shape (a
one-query call is bound by its bytes, which count every key). Without
replays it reads what ``flash_roofline.goal`` reads."""
from portbench import idle, roofline, spans

KERNELS = ("flash_split_kernel", "flash_tile_kernel")
# The program's name of the kernel that each trace name above belongs to.
PROGRAM_NAMES = dict(zip(KERNELS, ("flash_attention_split", "flash_attention_tile")))


def _bound(call) -> float:
    B, H, L, D = call.q_shape
    return roofline.attention_bound_s(B, H, L, call.keys, D, call.element_size,
                                      call.valid_keys, call.valid_keys is not None)


def replayed_bound_s(events) -> float:
    """The bounds of the flash calls that the trace's ``sampler/graph``
    spans replayed; None where a replayed kernel has no counted call."""
    from nvblox_mindmap_torch.ops import flash_attention as fa

    counted = getattr(fa, "REPLAYED", None) or {}
    mean = {}
    for name in PROGRAM_NAMES.values():
        calls = [(call, n) for call, n in counted.items() if call.name == name]
        total = sum(n for _, n in calls)
        if total:
            mean[name] = sum(_bound(call) * n for call, n in calls) / total
    bound = 0.0
    for e in spans.launched_ops(events, "sampler/graph"):
        kernel = next((k for k in KERNELS if k in e["name"]), None)
        if kernel is None:
            continue
        if PROGRAM_NAMES[kernel] not in mean:
            return None
        bound += mean[PROGRAM_NAMES[kernel]]
    return bound


def read(run):
    if not spans.on_card(run) or not run.flash_calls:
        return None
    device_s = sum(float(e["dur"]) for e in idle.device_ops(run.events)
                   if any(k in e["name"] for k in KERNELS)) / 1e6
    replayed = replayed_bound_s(run.events)
    if replayed is None or device_s <= 0:
        return None
    return 100.0 * (run.flash_bound_s + replayed) / device_s
