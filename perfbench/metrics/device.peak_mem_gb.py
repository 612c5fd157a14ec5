"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated``, reset at the window's start), in
GB (1e9 bytes)."""


def read(records):
    peak = records.get("peak_mem_bytes")
    return peak / 1e9 if peak else None
