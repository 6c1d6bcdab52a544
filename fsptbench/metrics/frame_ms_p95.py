"""frame_ms_p95: for every drag event of the window, from its due time to
the publication of the first frame rendered with it applied; the 95th
percentile (nearest rank) over all events.  An event no frame reflected
counts with the time waited for it."""

from fsptbench.yardstick import percentile


def read(run):
    lat = [r["latency_s"] for r in run.records]
    return percentile(lat, 95) * 1e3 if lat else None
