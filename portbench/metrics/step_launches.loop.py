"""Device operations (kernels, copies, memsets) launched per sim step (the
program's ``policy/step`` span: decay, features and fusion of every
camera)."""
from portbench import spans


def read(run):
    return spans.launches_per(run.events, "policy/step") if spans.on_card(run) else None
