"""setup_first_unit_s: self seconds of set-up span ``setup.first_unit``,
the process's first round or fused step, closed by a synchronisation."""

from gpubench import setup_stages


def read(ctx):
    return setup_stages.read("setup_first_unit_s")
