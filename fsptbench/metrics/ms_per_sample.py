"""ms_per_sample: the whole window's wall time over the samples of every
step completed in it (closed loop, one step after another)."""


def read(run):
    samples = sum(r["samples"] for r in run.records)
    return run.window_s * 1e3 / samples if samples else None
