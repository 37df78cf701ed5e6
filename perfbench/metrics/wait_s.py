"""Host seconds per call blocked on the device: the program's
``census.wait`` host ranges (a staging buffer's last copy, a dispatch's
partials) in the traced window over the calls.  One reader for every
cell kind (``wait_s.census``, ``wait_s.update``).  Nothing where the
program opens no such range."""

UNIT = "s"
SPAN = "census.wait"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or SPAN not in trace["host_s"]:
        return None
    return trace["host_s"][SPAN] / ctx["calls"]
