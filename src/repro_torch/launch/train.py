"""Training launcher (counterpart of ``repro/launch/train.py``): a shim
over the port's spec CLI, ``python -m repro_torch.launch train``.

The reference's flags (``--arch --optimizer --estimator --q --lr --eps
--sparsity --backend --forward-backend --peft --task --seq-len
--ckpt-dir --ckpt-every --quorum --loss-shards --seed --steps
--batch-size --out``) are the CLI's generated alias flags, plus
``--device``.
"""
from __future__ import annotations

import sys

from repro_torch.launch import cli


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return cli.main(["train"] + argv)


if __name__ == "__main__":
    main()
