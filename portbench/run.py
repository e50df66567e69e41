"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the ``breakdown``, and last the ``checks``: each number that
decided ``correct`` beside its limit); the checks are also the last lines
of standard error. An earlier line names the host's CPU and the card's
clocks and power limit. Without a card, or with fewer than the cell asks
for, it exits with 2 and prints no result; with JAX or the JAX package
loaded once the window has closed, with 3.
"""
import os
import sys
import time

START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# Kernel caches at fixed paths inside the checkout; few host threads.
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH_DIR, ".cache", "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(BENCH_DIR, ".cache", "inductor")
os.environ["USE_FLAX"] = "0"
HOST_THREADS = 4
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(HOST_THREADS)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def host_line(device) -> dict:
    import torch

    cpu = smi = None
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        cpu = {k.strip(): v.strip() for k, v in (line.split(":", 1) for line in
               lscpu.splitlines() if ":" in line)}
        cpu = {k: cpu.get(k) for k in ("Architecture", "Model name", "Vendor ID", "CPU(s)")}
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"host_cpu": cpu, "card": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness

    chips = {w["name"]: w["chips"] for w in harness.load_benchmark()["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    device = torch.device("cuda", 0)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device, START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded once the window had closed: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps({"host": host_line(device), "notes": result["notes"]}), flush=True)
    print(harness.result_line(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
