"""setup_s: seconds from the process's start to the window's: the
program and the kernels loaded, the instances made, the shapes warmed."""


def read(ctx):
    return ctx.setup_s
