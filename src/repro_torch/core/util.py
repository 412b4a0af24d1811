"""Small shared integer helpers for padding/partitioning arithmetic."""
from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    """ceil(a / b) for non-negative ints (b > 0)."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Smallest multiple of ``b`` that is >= ``a`` (b > 0)."""
    return ceil_div(a, b) * b
