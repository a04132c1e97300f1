"""``fused_row_update_roofline``: the fused kernel's share of its roofline, in %.

Its launches are the trace's ``fused_rows_kernel`` events, its time theirs
and its scatter's (``scatter_rows_kernel``). The work of a launch is the
least that one slot's applied updates need (``perfbench/work.py``), at the
traced stretch's applied updates a slot.
"""

from perfbench import work


def read(ctx):
    t = ctx["trace"]
    if not t or not t["steps"]:
        return None
    ev = [e for e in t["device"] if "fused_rows_kernel" in e[0] or "scatter_rows_kernel" in e[0]]
    launches = sum(1 for e in ev if "fused_rows_kernel" in e[0])
    if not launches:
        return None
    per_launch = sum(e[2] for e in ev) / 1e6 / launches
    nbytes, flops = work.slot_work(ctx["config"], ctx["n"], ctx["nnz"], t["updates"] / t["steps"])
    return 100.0 * work.bound_seconds(nbytes, flops) / per_launch
