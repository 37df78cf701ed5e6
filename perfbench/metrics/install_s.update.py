"""Host seconds per update writing the session's resident graph: the
program's ``census.session.install`` host ranges (padding and the copies
to the device) in the traced window over the updates.  Nothing where the
program opens no such range."""

UNIT = "s"
SPAN = "census.session.install"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or SPAN not in trace["host_s"]:
        return None
    return trace["host_s"][SPAN] / ctx["calls"]
