"""train_step_ms: the whole window's wall time over the train steps
completed in it (closed loop, forward and backward, one after another)."""


def read(run):
    return run.window_s * 1e3 / len(run.records) if run.records else None
