"""``mfu.round``: a synchronous round's share of the card's peak, in %.

The least bytes and float32 operations of one round (``perfbench/work.py``:
the (n, p) models read and written once, the CSR graph, every agent's
points, targets and constants), as time at the card's peak rates, times the
window's rounds, over the time of the untraced window.
"""

from perfbench import work


def read(ctx):
    w = ctx["window"]
    if ctx["unit"] != "round" or not w["steps"]:
        return None
    nbytes, flops = work.round_work(ctx["config"], ctx["n"], ctx["nnz"])
    return 100.0 * w["steps"] * work.bound_seconds(nbytes, flops) / w["seconds"]
