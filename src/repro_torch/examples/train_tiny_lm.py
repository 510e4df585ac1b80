"""Train a reduced-family model end-to-end for a few hundred steps
(``--arch``, default ``mamba2-130m`` SMOKE) through
``repro_torch.launch.train``, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm \\
        --arch mamba2-130m --steps 200 [--device cpu]
"""
from __future__ import annotations

import sys

from repro_torch.launch import train


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--steps") for a in argv):
        argv += ["--steps", "200"]
    return train.main(argv)


if __name__ == "__main__":
    main()
