"""Device idle share of the traced window: 1 less the union of kernel,
copy and memset spans over the window.  Nothing without device activity
in the trace."""

UNIT = "%"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace["device_events"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
