"""Seconds from the process's start to the window's: imports, the CUDA
context, structure, model, warm-up and captures, and the warm pass."""


def read(ctx):
    return ctx.setup_s
