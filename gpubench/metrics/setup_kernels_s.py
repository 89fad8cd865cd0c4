"""setup_kernels_s: self seconds of set-up span ``setup.kernels``, the
source digests, any ``nvcc`` build and the ``ctypes`` loads of the kernel
libraries."""

from gpubench import setup_stages


def read(ctx):
    return setup_stages.read("setup_kernels_s")
