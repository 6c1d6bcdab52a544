"""frames_per_s.view: preview frames the viewer published in the window
over the window's seconds, both without the profiled slice (from the
profiler's start to its stop), whose frames the profiler slows."""


def read(run):
    frames = run.facts.get("frames_untraced")
    return frames / run.facts["untraced_s"] if frames else None
