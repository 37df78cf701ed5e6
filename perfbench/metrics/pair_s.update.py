"""Host seconds per update in pair-space maintenance and affected-pair
discovery (``host_pair_seconds``), from the session's ``EngineStats``
after each update."""

UNIT = "s"


def read(ctx):
    return sum(r["pair_s"] for r in ctx["records"]) / ctx["calls"]
