"""Seconds from the process's start to the window's: imports, the kernels'
load (and build, in a checkout's first run), rendering, the JPEG files, and
the warm pass over every distinct pair."""


def read(r):
    return r.setup_s
