"""span_ms.step_self: the self time of the program's `fspt.step`
spans in the profiled slice (Renderer.step less its phase spans: raygen,
the table builds, primary shading, the deposit, accumulation and the
synchronise), in ms over the slice's samples.  In an eager step it sums,
with the self times of the step's phase spans (fspt.shade, .uniforms,
.sort, .compact, .traverse), to the slice's fspt.step time."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.step", "samples")
