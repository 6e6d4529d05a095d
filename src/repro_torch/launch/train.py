"""Training launcher: not ported yet.

The counterpart of ``repro/launch/train.py`` (the LM trainer with its
optimizers and checkpoints) is ROADMAP.md item A15.2; the port serves LMs
(``python -m repro_torch.launch.serve``) but does not train them.
"""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError("LM training is not ported yet: ROADMAP.md item A15.2")


if __name__ == "__main__":
    main()
