"""The benchmark."""
