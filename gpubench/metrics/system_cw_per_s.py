"""system_cw_per_s: frames through the capture step and, for its captured
rows, phase 2, over the whole window closed by a synchronisation."""


def read(ctx):
    if ctx.kind != "system":
        return None
    return ctx.frames / ctx.window_s
