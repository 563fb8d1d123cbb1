"""Frozen copy of the program's host utilities."""
