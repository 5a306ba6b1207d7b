"""LAF303 ok twin: the wrapper launches (and counts, and fakes) it."""
from repro_torch.kernels.popcount import row_popcount


def count_rows(words):
    return row_popcount(words)
