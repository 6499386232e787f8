"""Operator registry and lowerings."""
