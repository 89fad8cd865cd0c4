"""setup_device_s: self seconds of set-up span ``setup.device``, the
card's primary context made at ``resolve_device``'s first call for it."""

from gpubench import setup_stages


def read(ctx):
    return setup_stages.read("setup_device_s")
