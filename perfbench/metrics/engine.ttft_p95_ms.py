"""95th percentile of time to first token (the program's telemetry:
``RequestRecord.ttft_s``, first token less submit) of the requests whose
first token came in the window; in a closed loop submit is the send."""

from perfbench.harness.stats import percentile


def read(rec):
    t = rec.get("ttft_s")
    return percentile(t, 95) * 1e3 if t else None
