"""Frozen copies of the nuclear data tables the reference reads."""
