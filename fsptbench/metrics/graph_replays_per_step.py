"""graph_replays_per_step: the program's `fspt.replay` spans (one a launch
of a captured sample batch) in the profiled slice, over the slice's steps;
0.0 where the slice's steps replayed nothing (a program that runs every
step eagerly)."""

from fsptbench.spans import spans


def read(run):
    if run.slice is None or not run.slice_work.get("steps"):
        return None
    found = [s for s in spans(run.slice) if s[0] == "fspt.replay"]
    return len(found) / run.slice_work["steps"]
