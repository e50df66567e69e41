"""Readings that the limits deciding ``correct`` are set from, taken on the
card at a cell's own size, in one process: each seed's set-up and a short
window, then the program's numbers against the plain reference; on the
control seeds also the control's (the reference in the control's
arithmetic, ``reference/precision.py``, put in the program's place), and
for a training cell the planted faults'.

    python3 portbench/calibrate.py --workload <cell> --seconds 4 \\
        --seeds 11 12 13 --control-seeds 11 12 13

Prints one JSON line per seed. The benchmark's own runs never run this.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402


def readings(cell: str, seed: int, seconds: float, control: bool, device, overrides=None) -> dict:
    from portbench import harness

    start = time.perf_counter()
    run, driver, state, entries = harness.prepare(cell, seed, seconds, False, device, start,
                                                  overrides)
    harness.measure(run, driver, state)
    out = {"cell": cell, "seed": seed, "setup_s": run.setup_s, "failed": run.failed,
           "program": driver.check(run, state), "limits": entries["limits"],
           "notes": run.notes}
    if control:
        out["control"] = driver.control(run, state)
        if hasattr(driver, "faults"):
            out["faults"] = driver.faults(run, state)
    out["seconds"] = time.perf_counter() - start
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    for seed in args.seeds:
        line = readings(args.workload, seed, args.seconds, seed in args.control_seeds,
                        torch.device("cuda", 0))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
