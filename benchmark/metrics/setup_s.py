"""Seconds from the benchmark's start (before it imports torch) to the
window's start: the corpus drawn, every index built, attached and warmed,
the kernels built or loaded, the warm-up calls made."""


def read(run):
    return run.setup_s
