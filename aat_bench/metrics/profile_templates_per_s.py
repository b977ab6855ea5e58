"""Templates scored in the window's completed profile screens, over the
window's wall."""


def read(run):
    n = sum(s.work.get("templates", 0) for s in run.screens)
    return n / run.window_s if n else None
