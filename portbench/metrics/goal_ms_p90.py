"""90th percentile of the window's goal times: the tail a closed loop waits
on (the highest percentile with at least ten goals beyond it at ~100-200
goals a window)."""
import statistics


def read(run):
    goals = run.latencies.get("goal")
    if not goals or len(goals) < 2:
        return None
    return statistics.quantiles(goals, n=10)[8] * 1e3
