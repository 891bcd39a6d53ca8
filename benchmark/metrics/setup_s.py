"""Seconds from the process's start to the first timed query: the
imports, the CUDA context, the program's kernel builds (a checkout's
first run only), the inputs from the seed, the program's tables and the
warm-up queries."""


def read(run, token=None):
    return run.setup_s
