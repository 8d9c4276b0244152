"""Synthetic data: vector collections (``vectors``, numpy only) and the
LM's token stream (``synthetic``)."""
