"""Device ms per camera frame of the feature-pool update: the operations
launched under the program's ``mapper/features`` span
(``Mapper.add_feature_frame``)."""
from portbench import spans


def read(run):
    return spans.device_ms_per(run.events, "mapper/features") if spans.on_card(run) else None
