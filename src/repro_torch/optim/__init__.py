"""Optimizer of the port (``repro.optim``): AdamW."""
