"""Training driver of the port (counterpart of ``repro/train``)."""
