"""The deterministic synthetic data pipeline (``pipeline``); host code."""
