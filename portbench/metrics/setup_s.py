"""Seconds from the process's start to the window's: start-up, building the
system, the weights, the CUDA libraries and the warm-up."""


def read(run):
    return run["ctx"].setup_s
