"""From the process's start to the window's start (host clock)."""


def read(r):
    return r["setup_s"]
