"""``setup_s``: seconds from the process's start to the first timed call:
imports, the inputs from the seed, the program's objects, the kernel build
where it is not cached, and the warm-up of the mix's shapes."""


def read(ctx):
    return ctx["setup_seconds"]
