"""Occupancy-grid volume renderer."""
