"""Seconds in ``SearchArray.index(...)`` (tokenize, invert, encode on the
host), summed over the cell's indexes."""


def read(run):
    return run.setup.seconds("build")
