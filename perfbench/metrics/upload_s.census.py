"""Host seconds per census staging windows for the device: the program's
``census.upload`` host ranges (each window's copy into a pinned buffer
and the enqueue of its copy to the device) in the traced window over the
censuses.  Nothing where the program opens no such range."""

UNIT = "s"
SPAN = "census.upload"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or SPAN not in trace["host_s"]:
        return None
    return trace["host_s"][SPAN] / ctx["calls"]
