"""Device ms per traced train step of the optimizer: the operations
launched under the program's ``trainer/optimizer`` span (AdamW's step and
``zero_grad``)."""
from portbench import spans


def read(run):
    return spans.device_ms_per(run.events, "trainer/optimizer") if spans.on_card(run) else None
