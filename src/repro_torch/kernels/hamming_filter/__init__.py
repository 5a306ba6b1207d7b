from .ops import (  # noqa: F401
    hamming_filter_bitmap,
    hamming_filter_count,
    hamming_filter_into,
)
