"""Host-to-device plan megabytes per census, from two of the program's
``EngineStats`` counters after each census: what each dispatch uploads
(``plan_upload_bytes``) times the dispatches (``chunks``) and devices
(``ndev``).  The single-device stream leaves ``plan_upload_bytes_total``
unset, so the product is read in every cell."""

UNIT = "MB"


def read(ctx):
    return sum(r["upload_bytes"] for r in ctx["records"]) / ctx["calls"] / 1e6
