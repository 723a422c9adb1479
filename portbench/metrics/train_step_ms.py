"""train_step_ms (ms, host clock): window ms / steps completed, the step in
flight at the deadline counted and ending the window."""


def read(run):
    return 1e3 * run.window.seconds / run.window.calls
