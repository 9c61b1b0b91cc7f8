"""Attention ops: the naive reference, the flash forward and paged decode."""
