"""Model stack of the port: config schema, layers and the OPT LM
(counterpart of ``repro/models``)."""
