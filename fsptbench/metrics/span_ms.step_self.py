"""span_ms.step_self: the self time of the program's `fspt.step`
spans in the profiled slice (Renderer.step less its phase spans: raygen,
the table builds, primary shading, the deposit, accumulation and the
synchronise), in ms over the slice's samples.  With the five other
span_ms metrics of a progressive cell it sums to the slice's fspt.step
time."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.step", "samples")
