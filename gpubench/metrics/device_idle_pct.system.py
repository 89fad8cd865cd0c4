"""device_idle_pct.system: the share of a unit's wall time, at the pace of
the traced run's untraced lead, in which no device operation ran: 1 minus
a unit's busy device seconds in the traced rest (the union of the
operations' intervals) over a unit's seconds in the lead; two-phase
rounds."""


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    busy = ctx.trace["busy_s"] / ctx.units
    wall = ctx.lead["window_s"] / ctx.lead["units"]
    return 100.0 * (1.0 - busy / wall)
