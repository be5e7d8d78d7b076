"""Serving: per-level generation engine and the ALERT servers."""
