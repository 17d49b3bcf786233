"""Set-up, in seconds: from the process's start to the window's opening:
imports, weights, the engine, the kernels' build where it is not yet
done, the warm-up of the cell's step shapes, and the pre-roll."""


def read(run):
    return run.setup_s
