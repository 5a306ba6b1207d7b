"""LAF304 bad twin: the wrapper's mirror of kRows disagrees with the
kernel, and its own divisibility check fails on its constant."""
ROWS_PER_BLOCK = 64  # the kernel's query rows per block (kRows)
TILE_WORDS = 6       # words of a tile (WORDS_PER_TILE)


def grid(nq, words):
    if TILE_WORDS % 4:
        raise ValueError("a tile holds whole uint4 loads")
    return -(-nq // ROWS_PER_BLOCK)
