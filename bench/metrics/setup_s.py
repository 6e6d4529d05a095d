"""Seconds from the process's start to the window's opening: imports, the
library (its nvcc build on a checkout's first run), the rows from the seed
on the card and the warm-up at the cell's shapes."""


def read(rec):
    return rec["setup_s"]
