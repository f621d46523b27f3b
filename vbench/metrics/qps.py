"""qps: answers that came back inside the window over the window's
length."""


def read(run):
    return run.window.completions / run.window.seconds
