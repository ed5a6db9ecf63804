"""The allocator's peak on the card over the run up to the window's close
(``torch.cuda.max_memory_allocated``, reset at the start of set-up): the
weights, the page pool or activations, and what the window adds."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
