"""Dry-run launcher: not ported yet.

The counterpart of ``repro/launch/dryrun.py`` (lowering every architecture
and shape cell on a virtual mesh, with the roofline analysis of
``repro/roofline/``) is ROADMAP.md item A15.4: it reads XLA's HLO costs,
which have no PyTorch equivalent yet.
"""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError("the dry-run and roofline tools are not ported yet: "
                              "ROADMAP.md item A15.4")


if __name__ == "__main__":
    main()
