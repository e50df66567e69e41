"""Device ms per traced goal of the model's language layers (the union of
the operations launched inside the program's ``encoder/language`` spans:
the instruction encoder and the vision-language attention, one span a
goal's encoding). None where the program has no such span."""
from portbench import spans


def read(run):
    return spans.device_ms_per(run.events, "encoder/language") if spans.on_card(run) else None
