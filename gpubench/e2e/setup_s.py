"""Process start to the window's opening: imports, the kernels' load,
weights, quantization, pool, graph capture, warm-up, a backlog's first
fill."""

NAME, UNIT = "setup_s", "s"


def read(run):
    return run["setup_s"]
