"""``mfu.update``: an asynchronous slot's share of the card's peak, in %.

The least bytes and float32 operations that the window's applied updates
need (``perfbench/work.py``: each slot's distinct model rows, the agents'
data, neighbour lists and constants, the rows written), as time at the
card's peak rates, over the time of the untraced window. Read from the
window's own count of applied updates and slots.
"""

from perfbench import work


def read(ctx):
    w = ctx["window"]
    if ctx["unit"] != "slot" or not w["steps"] or not w["updates"]:
        return None
    nbytes, flops = work.slot_work(ctx["config"], ctx["n"], ctx["nnz"], w["updates"] / w["steps"])
    return 100.0 * w["steps"] * work.bound_seconds(nbytes, flops) / w["seconds"]
