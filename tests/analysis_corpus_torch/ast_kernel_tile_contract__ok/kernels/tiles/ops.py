"""LAF304 ok twin: the mirrors agree with the kernel and hold the
wrapper's divisibility check."""
ROWS_PER_BLOCK = 128  # the kernel's query rows per block (kRows)
TILE_WORDS = 4        # words of a tile (WORDS_PER_TILE)


def grid(nq, words):
    if TILE_WORDS % 4:
        raise ValueError("a tile holds whole uint4 loads")
    return -(-nq // ROWS_PER_BLOCK)
