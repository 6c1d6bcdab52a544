"""kernels_per_sample: CUDA kernel events of the profiled slice over the
samples its steps completed."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or not run.slice_work.get("samples"):
        return None
    return len(s.kernels) / run.slice_work["samples"]
