"""edit_s: the window's wall time over the edits it completed, on the
client's clock around each HTTP request (end to end)."""

UNIT = "s"


def read(run):
    return run.window_s / len(run.done) if run.done else None
