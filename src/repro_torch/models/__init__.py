"""Model code of the port: layers, attention projections, LM parameters."""
