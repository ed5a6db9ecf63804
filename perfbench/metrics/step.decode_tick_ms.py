"""Mean duration of the engine's ``decode_tick`` span (one batched decode,
ended by its token readback) over the ticks of the window."""


def read(rec):
    s = rec.get("spans", {}).get("decode_tick")
    return sum(s) / len(s) * 1e3 if s else None
