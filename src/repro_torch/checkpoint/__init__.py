"""Atomic checkpoints of nested trees of arrays (port of
``repro.checkpoint``)."""
