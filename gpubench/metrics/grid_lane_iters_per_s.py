"""grid_lane_iters_per_s: lane-iterations per second of the grid's EM, the
lane-iterations that the window's jobs ran (each lane chunk's EM
iterations times its lanes) over the window's length (host clock). The
window's time holds every part of its jobs: the starts, the rescoring, the
selection and the drawing of each job's bank."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j["work"]["lane_iters"] for j in ctx.jobs) / ctx.window_s
