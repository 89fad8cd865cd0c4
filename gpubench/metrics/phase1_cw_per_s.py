"""phase1_cw_per_s: frames counted by the fused Monte-Carlo steps over the
whole window closed by a synchronisation."""


def read(ctx):
    if ctx.kind != "phase1":
        return None
    return ctx.frames / ctx.window_s
