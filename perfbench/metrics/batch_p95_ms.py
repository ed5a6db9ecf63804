"""95th percentile over the batches that end in the window of one batch's
wall time, from the call into the model to the end of its
``torch.cuda.synchronize()``."""

from perfbench.harness.stats import percentile


def read(rec):
    b = rec.get("batch_s")
    return percentile(b, 95) * 1e3 if b else None
