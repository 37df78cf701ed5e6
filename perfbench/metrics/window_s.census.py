"""Engine window-emission seconds per census: the program's
``census.window`` host ranges in the traced window over the censuses."""

UNIT = "s"


def read(ctx):
    if ctx["trace"] is None:
        return None
    return ctx["trace"]["host_s"].get("census.window", 0.0) / ctx["calls"]
