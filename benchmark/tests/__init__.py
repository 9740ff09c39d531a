"""Tests of the benchmark, on the CPU; those marked ``cuda`` need the cards."""
