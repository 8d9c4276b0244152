"""Synthetic vector collections (numpy only)."""
