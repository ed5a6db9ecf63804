"""The paged decode kernel's share of its roofline over the window: the
least time its work needs (every live K / V row of each active sequence,
q and the output, once, at the H100's 3.35 TB/s) over its device time in
the trace (launches of ``paged_decode_kernel``)."""

from perfbench.harness.flops import HBM_BYTES_PER_S


def read(rec):
    t = (rec.get("trace") or {}).get("paged_decode")
    if not t or t["device_s"] <= 0 or t["bytes"] <= 0:
        return None
    return 100.0 * t["bytes"] / HBM_BYTES_PER_S / t["device_s"]
