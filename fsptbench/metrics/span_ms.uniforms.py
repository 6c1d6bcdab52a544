"""span_ms.uniforms: the self time of the program's `fspt.uniforms`
spans in the profiled slice (_bounce's PCG4D uniforms of an iteration), in
ms over the slice's samples."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.uniforms", "samples")
