"""Measurement tools for the port, run on the card."""
