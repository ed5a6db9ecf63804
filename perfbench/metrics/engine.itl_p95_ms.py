"""95th percentile of the gaps between two consecutive tokens of one
request, both delivered in the window, by the harness's clock at the end
of each engine tick (a tick ends with the token readback)."""

from perfbench.harness.stats import percentile


def read(rec):
    g = rec.get("itl_s")
    return percentile(g, 95) * 1e3 if g else None
