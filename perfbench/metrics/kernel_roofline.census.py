"""The census's share of its roofline: the graph's least census time
(``perfbench.roofline``) over the device time of every kernel in the
traced window per census, the port's census kernels and any other kernel
the census launches (fills, ``arange``) alike; copies and memsets are
not kernels.  Nothing without kernels in the trace."""

from perfbench import roofline

UNIT = "%"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx["least"] is None or not trace["kernel_s"]:
        return None
    return 100.0 * roofline.least_seconds(ctx["least"]) / (
        trace["kernel_s"] / ctx["calls"])
