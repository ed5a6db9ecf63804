"""Share of the dense model's FLOPs that SPLS's packed compute did not
execute in the window: 100 x (1 - executed / dense) over Q, K, V and the
output projection (``qkv``), attention (``attn``) and the FFN (``ffn``),
from the difference of the scheduler's lifetime accumulators
(``engine.sched.flops``) across the window.  ``kv`` is left out: the
program folds it into ``qkv`` as well."""


def read(rec):
    f = rec.get("flops", {})
    dense = sum(f[c][0] for c in ("qkv", "attn", "ffn") if c in f)
    done = sum(f[c][1] for c in ("qkv", "attn", "ffn") if c in f)
    return 100.0 * (1.0 - done / dense) if dense > 0 else None
