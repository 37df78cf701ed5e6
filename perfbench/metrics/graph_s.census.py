"""Host seconds per census putting the graph on the device: the
program's ``census.graph`` host ranges (graph arrays and flat item
index, uploaded every census) in the traced window over the censuses.
Nothing where the program opens no such range."""

UNIT = "s"
SPAN = "census.graph"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or SPAN not in trace["host_s"]:
        return None
    return trace["host_s"][SPAN] / ctx["calls"]
