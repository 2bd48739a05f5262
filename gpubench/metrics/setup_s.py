"""setup_s: seconds from process start to the first measured job, the warm
job (and, in a fresh checkout, the kernels' build) included."""


def read(ctx):
    return ctx.setup_s
