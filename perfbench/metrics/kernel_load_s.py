"""Host seconds of the first load of the program's kernel library (a build
in a checkout's first run, a cached load after it); none off the card."""


def read(ctx: dict):
    return ctx['kernel_load_s']
