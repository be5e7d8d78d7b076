"""Training losses and train-step factories (port of ``repro.train``)."""
