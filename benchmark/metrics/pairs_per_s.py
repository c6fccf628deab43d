"""Pairs whose cloud reached host memory inside the window, over its seconds."""


def read(r):
    return r.window.completed / r.window.seconds
