"""span_ms.backward.train: the whole duration of the program's
`fspt.train.backward` spans in the profiled slice (make_train_step: a
shard's torch.autograd.grad, on the calling thread), in ms over the
slice's train steps."""

from fsptbench.spans import ms_per


def read(run):
    return ms_per(run, "fspt.train.backward", "steps", own=False)
