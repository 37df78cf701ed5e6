"""Host planner seconds per census: the program's ``census.plan`` host
ranges in the traced window over the censuses."""

UNIT = "s"


def read(ctx):
    if ctx["trace"] is None:
        return None
    return ctx["trace"]["host_s"].get("census.plan", 0.0) / ctx["calls"]
