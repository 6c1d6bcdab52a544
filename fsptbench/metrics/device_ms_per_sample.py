"""device_ms_per_sample: the union of the device's kernel, memcpy and
memset intervals in the profiled slice over the samples of the slice."""


def read(run):
    s = run.slice
    if s is None or not s.busy or not run.slice_work.get("samples"):
        return None
    return s.busy_s * 1e3 / run.slice_work["samples"]
