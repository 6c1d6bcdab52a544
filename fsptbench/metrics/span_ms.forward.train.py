"""span_ms.forward.train: the whole duration of the program's
`fspt.train.forward` spans in the profiled slice (make_train_step: a
shard's radiance and loss, its phase spans included), in ms over the
slice's train steps."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.train.forward", "steps", own=False)
