"""Fault tolerance on one device: the injected failure, the lane groups of
a device loss and the straggler monitor (port of ``repro.runtime``)."""
