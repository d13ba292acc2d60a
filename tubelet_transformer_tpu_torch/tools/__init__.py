"""Measurement tools of the port that are not part of its entry points."""
