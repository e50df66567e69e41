"""Host waits on the card per traced goal issued under the program's
``policy/goal`` span: runtime calls ``cudaStreamSynchronize``,
``cudaEventSynchronize`` and synchronous ``cudaMemcpy`` (a copy to or from
pageable host memory ends in a stream synchronize). ``cudaDeviceSynchronize``
is not counted: the program never calls it, and the benchmark's own spans
around the program's calls do."""
from portbench import spans


def read(run):
    return spans.syncs_per(run.events, "policy/goal") if spans.on_card(run) else None
