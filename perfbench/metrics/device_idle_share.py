"""``device_idle_share``: the share of the traced stretch in which no
operation ran on the card, in % (1 - the union of the device events'
intervals over the stretch's wall time, from the profiler's trace)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["seconds"])
