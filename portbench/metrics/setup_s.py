"""setup_s: seconds from the start of the process to the first solve of
the window: imports, the CUDA context, the kernel library and the codec
(built on a checkout's first run), the seed's initial state and the warm
solve."""


def read(run):
    return run.setup_s
