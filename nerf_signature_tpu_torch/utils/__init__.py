"""CLI flags and device resolution."""
