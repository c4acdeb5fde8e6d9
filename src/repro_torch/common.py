"""Shared small utilities."""
from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
