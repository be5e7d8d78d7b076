"""Launchers (port of ``repro.launch``): training and serving on one
device."""
