"""setup_import_s: self seconds of set-up span ``setup.import``, the
port's imports from its package's first line to the process's first other
set-up span."""

from gpubench import setup_stages


def read(ctx):
    return setup_stages.read("setup_import_s")
