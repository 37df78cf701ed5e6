"""Host seconds per update in the ``apply_delta`` graph edit
(``host_merge_seconds``), from the session's ``EngineStats`` after each
update."""

UNIT = "s"


def read(ctx):
    return sum(r["merge_s"] for r in ctx["records"]) / ctx["calls"]
