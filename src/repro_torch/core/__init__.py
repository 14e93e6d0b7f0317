"""ZO core of the port: counter RNG, layer selection, ZOSpec and the
tree axpy (counterpart of ``repro/core``)."""
