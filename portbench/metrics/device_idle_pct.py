"""Share of the traced window in which no operation ran on the device,
%: one minus the union of the profiler's device intervals over the
window.  Nothing to read where the profiler saw no device operation."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
