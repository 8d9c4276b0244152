"""Histogram GBDT: the recall predictor's model, inference and trainer."""
