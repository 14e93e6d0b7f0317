"""``python -m repro_torch.launch <cmd>`` — the port's spec-driven CLI
(counterpart of ``repro/launch/__main__.py``)."""
from repro_torch.launch import cli

if __name__ == "__main__":
    raise SystemExit(cli.console())
