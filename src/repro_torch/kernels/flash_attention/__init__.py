from .ops import flash_attention  # noqa: F401
