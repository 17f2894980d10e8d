"""Data of the port (``repro.data``): the synthetic token pipeline."""
