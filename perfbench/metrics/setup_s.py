"""Seconds from the process's start to the first timed request: imports,
the weights drawn on the device, kernel builds (cached in the checkout
after the first run) and the warm-up batch."""


def read(run):
    return run.setup_s
