"""Runner: real tokens over the rows the executed steps ran, in %.  The
runner pads decode rows to ``max_batch`` and every prefill slot to the
chunk width; counted from each executed schedule of the window."""


def read(run):
    steps = run.window_steps
    padded = sum(s.padded_rows for s in steps)
    if not padded:
        return None
    return 100.0 * sum(s.real_tokens for s in steps) / padded
