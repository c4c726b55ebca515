"""Process start to the window's opening: loading, weights, quantization,
kernel loading or building, graph capture and the warm-up."""


def read(run):
    return run.setup_s
