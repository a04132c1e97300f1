"""``sparse_mix_roofline``: the ``sparse_mix`` kernel's share of its roofline
in a synchronous round, in %: the full neighbour sum's least work
(``perfbench/work.py``: the models read once, the CSR graph, the sums
written) over the device time of a ``sparse_mix_kernel`` launch."""

from perfbench import work


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["unit"] != "round":
        return None
    ev = [e for e in t["device"] if "sparse_mix_kernel" in e[0]]
    if not ev:
        return None
    nbytes, flops = work.mix_work(ctx["config"], ctx["n"], ctx["nnz"])
    return 100.0 * work.bound_seconds(nbytes, flops) / (sum(e[2] for e in ev) / 1e6 / len(ev))
