"""Hillclimb entry point (counterpart of ``repro/launch/hillclimb.py``): a
shim over the spec CLI (``python -m repro_torch.launch hillclimb``)::

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch deepseek-coder-33b --shape train_4k \\
        --set attn_k_chunk=2048 --variant optimized

Legacy spellings work here: ``--set key=val`` (a model-config
override) forwards as ``--cfg``, ``--variant`` as ``--lowering``; in
the spec CLI ``--set`` is reserved for spec overrides.  No card needed.
"""
import sys

from repro_torch.launch import cli


def _translate_legacy(argv):
    out = []
    for a in argv:
        if a == "--set":
            out.append("--cfg")
        elif a.startswith("--set="):
            out.append("--cfg=" + a.split("=", 1)[1])
        elif a == "--variant":
            out.append("--lowering")
        elif a.startswith("--variant="):
            out.append("--lowering=" + a.split("=", 1)[1])
        else:
            out.append(a)
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return cli.main(["hillclimb"] + _translate_legacy(argv))


if __name__ == "__main__":
    main()
