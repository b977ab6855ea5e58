"""Set-up: from the start of the run to the start of the window: imports,
loading (and in a first run building) the kernels, writing the inputs
from the seed, and one warm-up screen."""


def read(run):
    return run.setup_s
