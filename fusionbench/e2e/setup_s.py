"""Seconds from the process's start to the window's start: interpreter
and imports, the kernel library (built on a checkout's first run, loaded
after), the sweep, the session, its warm-up and one untimed cycle."""


def read(rec):
    return rec["setup_s"]
