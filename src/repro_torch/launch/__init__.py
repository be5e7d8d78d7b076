"""Launchers (port of ``repro.launch``): training and serving on one
device, the lane mesh of the decision plane (``mesh``) and its dry run
(``fleet_dryrun``)."""
