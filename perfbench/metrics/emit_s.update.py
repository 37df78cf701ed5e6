"""Host seconds per update in descriptor-window emission
(``host_emit_seconds``), from the session's ``EngineStats`` after each
update."""

UNIT = "s"


def read(ctx):
    return sum(r["emit_s"] for r in ctx["records"]) / ctx["calls"]
