from .ops import row_popcount  # noqa: F401
