"""Synthetic datasets and token streams (numpy only)."""
