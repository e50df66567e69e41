"""Median time of a whole ``get_new_goal``, from the call until the goal is
on the host, over every goal completed in the window."""
import statistics


def read(run):
    goals = run.latencies.get("goal")
    return statistics.median(goals) * 1e3 if goals else None
