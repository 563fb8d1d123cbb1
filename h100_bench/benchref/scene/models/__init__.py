"""Frozen copy of the program's host model modules."""
