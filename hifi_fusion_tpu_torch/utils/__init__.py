"""Synthetic depth sweeps."""
