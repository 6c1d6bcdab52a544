"""device_idle_pct.view: the device's idle share over the profiled
slice of viewer frames, in % (yardstick.slice_idle_pct)."""

from fsptbench.yardstick import slice_idle_pct as read  # noqa: F401
