"""ANN index substrate: exact flat search, IVF, k-means."""
