"""setup_s: from the process's start to the first request of the window
(loading, drawing and adding the rows, quantizing, the kernels' load or
build, and the warm-up)."""


def read(run):
    return run.setup_s
