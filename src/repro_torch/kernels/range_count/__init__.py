from .ops import range_count, range_count_bitmap, threshold  # noqa: F401
