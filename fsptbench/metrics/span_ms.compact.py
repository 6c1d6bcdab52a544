"""span_ms.compact: the self time of the program's `fspt.compact`
spans in the profiled slice (_compact: roulette keys, sort, row gathers),
in ms over the slice's samples."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.compact", "samples")
