"""Launch surface of the port (counterpart of ``repro/launch``):
``python -m repro_torch.launch <command>`` (``launch/cli.py``)."""
