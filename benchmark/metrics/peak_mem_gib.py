"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, in GiB."""


def read(rec):
    peak = rec["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak > 0 else None
