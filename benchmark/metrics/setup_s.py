"""``setup_s``: from the process's start to the window's start: imports,
the inputs made on the card, the kernels loaded (built on a checkout's first
run) and one warm-up epoch. Host clock."""


def read(record):
    return record["setup_s"]
