"""Launchers (port of ``repro.launch``): training on one device."""
