"""Dense decoder-only model code."""
