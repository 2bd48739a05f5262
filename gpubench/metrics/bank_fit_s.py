"""bank_fit_s: seconds per learning of the whole bank, the measured
window's length over the jobs completed in it (host clock)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
