"""setup_s: seconds from the start of run.py to the window's start:
imports, the CUDA context, kernels loaded from the build cache (built on
a checkout's first run), every client's streams and inputs, warm-up."""


def read(run):
    return run.setup_s
