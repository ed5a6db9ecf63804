"""The whole step's share of the card's peak: the dense model's FLOPs for
the tokens processed in the window (projections, FFN, attention over each
token's own context, the LM head where a token is produced), whatever the
program skipped, over the window's seconds times 67 TFLOP/s (the H100's
float32 peak outside the tensor cores; the program keeps TF32 off)."""

from perfbench.harness.flops import PEAK_FP32_FLOPS


def read(rec):
    f = rec.get("dense_flops")
    if not f or rec["window_s"] <= 0:
        return None
    return 100.0 * f / rec["window_s"] / PEAK_FP32_FLOPS
