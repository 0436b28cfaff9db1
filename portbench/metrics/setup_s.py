"""Seconds from the process's start to the window's open: generation,
loading, kernel builds and the warm-up of every statement instance."""


def read(r):
    return r.setup_s
