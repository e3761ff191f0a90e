"""Seconds from the index's first device attach through ``warm()`` (the
tf pool's hot rows) and ``warm_serving()``, summed over the cell's
indexes."""


def read(run):
    return run.setup.seconds("attach")
