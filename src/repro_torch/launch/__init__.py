"""Launchers of the port (``repro.launch``): the trainer."""
