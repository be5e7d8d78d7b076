"""The deterministic synthetic token pipeline (port of ``repro.data``)."""
