"""Optimizer of the port (``repro.optim``): AdamW, and int8 gradient
compression with error feedback."""
