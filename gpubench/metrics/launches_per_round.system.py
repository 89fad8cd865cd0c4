"""launches_per_round.system: device operations (kernels, copies, sets)
in the traced window over the rounds it ran."""


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None or not ctx.units:
        return None
    return ctx.trace["device_ops"] / ctx.units
