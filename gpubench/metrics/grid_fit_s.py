"""grid_fit_s: seconds per (K, S)-grid clustering, the measured window's
length over the jobs completed in it (host clock)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
