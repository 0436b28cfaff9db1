"""Statements completed with an answer in the window, over its seconds."""


def read(r):
    return len(r.in_window()) / r.seconds
