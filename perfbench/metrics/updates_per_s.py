"""``updates_per_s``: every Eq. 4 / Eq. 6 block update that the window
applied, over all of the window's time (host clock, from the first timed
call to the synchronize after the last). The loop counts the updates: the
state's own ``applied`` counter, or n a synchronous round."""


def read(ctx):
    w = ctx["window"]
    if not w["updates"]:
        return None
    return w["updates"] / w["seconds"]
