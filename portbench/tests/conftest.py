"""CPU fixtures of the benchmark's own tests: the repo root and the
port's sources on the path, torch at two threads, and smoke-sized cells
built from ``tests/data``.

    PYTHONPATH=src python -m pytest -q portbench/tests
"""
import json
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    torch.set_num_threads(2)


def smoke_cell(config="opt-smoke", traffic="lezo-b16-s64", limits=None,
               **over):
    """A cell of a smoke configuration under a shipped traffic mix cut to
    batch 4 of 16 tokens, held to the limits of cell ``limits``."""
    from portbench import spec

    cfg = json.loads((DATA / f"{config}.json").read_text())
    tr = json.loads((REPO / "portbench" / "traffic" /
                     f"{traffic}.json").read_text())
    tr = dict(tr, batch=4, seq_len=16, **over)
    lim = (json.loads((REPO / "portbench" / "limits" /
                       f"{limits}.json").read_text()) if limits else None)
    return types.SimpleNamespace(
        name=f"{config}.{traffic}", chips=1, config=cfg, traffic=tr,
        limits=lim, family=spec.family(cfg["family"]),
        end_to_end=json.loads((REPO / "BENCHMARK.json").read_text())[
            "end_to_end"], per_layer=[])
