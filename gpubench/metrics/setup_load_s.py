"""setup_load_s: self seconds of set-up spans ``setup.load_run`` (the run
directory's pickles onto the card) and ``setup.two_phase`` (the TEP
layout and the step builders of a two-phase system)."""

from gpubench import setup_stages


def read(ctx):
    return setup_stages.read("setup_load_s")
