"""walk3_roofline: the least bytes the slice's traversal needs
(yardstick.traversal_bytes: its rays, TraceStats.rays, read once and their
hits written once, and the packed tables read once a step) over the card's
3.35 TB/s, divided by the device time of the walk3 kernel (csrc/walk.cu's
walk_kernel; walk1_kernel, walk4_kernel and walk5_kernel do not match) in
the slice, in %."""

from fsptbench.yardstick import roofline_pct, traversal_bytes


def read(run):
    s = run.slice
    w = run.slice_work
    if s is None or not w.get("steps"):
        return None
    least = traversal_bytes(w["rays"], w["steps"], run.facts["table_bytes"])
    return roofline_pct(least, s.kernel_s("walk_kernel"))
