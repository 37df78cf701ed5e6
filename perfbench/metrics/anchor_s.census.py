"""Host seconds per census in anchor building: the program's
``census.window.anchors`` host ranges (each inside a ``census.window``)
in the traced window over the censuses.  Nothing where the program opens
no such range."""

UNIT = "s"
SPAN = "census.window.anchors"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or SPAN not in trace["host_s"]:
        return None
    return trace["host_s"][SPAN] / ctx["calls"]
