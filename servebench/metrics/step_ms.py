"""Engine loop: the window's seconds over the ``step()`` calls that ran
work in it, in ms."""


def read(run):
    n = sum(1 for s in run.window_steps if s.mode != "idle")
    return run.seconds * 1e3 / n if n else None
