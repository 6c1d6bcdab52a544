"""kernels_per_step.train: CUDA kernel events of the profiled slice over
the train steps it covers (the forward, torch.autograd.grad's backward and
the descent)."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or not run.slice_work.get("steps"):
        return None
    return len(s.kernels) / run.slice_work["steps"]
