"""span_ms.uniforms: the self time of the program's `fspt.uniforms` spans
in the profiled slice (_bounce's PCG4D uniforms of an iteration), in ms
over the slice's samples. No cell of BENCHMARK.json reports it: a step
replayed as a CUDA graph opens no phase span, so it reads None there;
eager steps still have the span."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.uniforms", "samples")
