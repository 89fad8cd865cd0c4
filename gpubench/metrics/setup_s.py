"""setup_s: seconds from the process's start to the first timed unit:
loading, the kernels' build on a checkout's first run, the warm-up."""


def read(ctx):
    return ctx.setup_s
