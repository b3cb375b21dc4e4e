"""Measurement tools that run on the card (not on any model path)."""
