"""Three-term roofline of a traced step (the port's ``roofline/analysis.py``).

    compute term    = flops_per_device / peak FLOP/s
    memory term     = bytes_per_device / HBM rate
    collective term = collective_bytes_per_device / link rate

The per-device counts come from :class:`~repro_torch.roofline.counter.OpCounter`
over one rank's program (the reference parses the partitioned HLO);
collective bytes use the reference's per-kind formulas on each record:

    all-gather         ~ result_bytes
    reduce-scatter     ~ operand_bytes
    all-reduce         ~ 2 * operand_bytes
    all-to-all         ~ operand_bytes
    collective-permute ~ operand_bytes

The peaks default to the H100's (``launch/mesh.py``).
"""

from __future__ import annotations

import dataclasses

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def collective_bytes(records) -> dict:
    """Per-device collective traffic by kind from collective records
    (``.kind``, ``.operand_bytes``, ``.result_bytes`` and ``.count``, the
    collectives a record stands for), with ``_counts``."""
    out = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for r in records:
        n = r.count
        if r.kind == "all-gather":
            out[r.kind] += n * r.result_bytes
        elif r.kind == "all-reduce":
            out[r.kind] += n * 2 * (r.operand_bytes or r.result_bytes)
        else:
            out[r.kind] += n * (r.operand_bytes or r.result_bytes)
        counts[r.kind] += n
    out["_counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_ratio: float
    collectives: dict

    def row(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "useful_ratio": self.useful_ratio,
        }


def roofline_terms(flops, nbytes, records, chips, model_flops_global, peak_flops=None,
                   hbm_bw=None, link_bw=None) -> Roofline:
    """The roofline of per-device ``flops``, ``nbytes`` and collective
    ``records`` on ``chips`` devices."""
    from repro_torch.launch.mesh import HBM_BW, IB_BW, PEAK_FLOPS_BF16

    peak_flops = peak_flops or PEAK_FLOPS_BF16
    hbm_bw = hbm_bw or HBM_BW
    link_bw = link_bw or IB_BW
    coll = collective_bytes(records)
    cbytes = float(sum(v for k, v in coll.items() if not k.startswith("_")))
    terms = {"compute": flops / peak_flops, "memory": nbytes / hbm_bw,
             "collective": cbytes / link_bw}
    dominant = max(terms, key=terms.get)
    global_flops = flops * chips
    return Roofline(
        flops_per_device=float(flops), bytes_per_device=float(nbytes),
        collective_bytes_per_device=cbytes, compute_s=terms["compute"],
        memory_s=terms["memory"], collective_s=terms["collective"], dominant=dominant,
        model_flops_global=model_flops_global,
        useful_ratio=model_flops_global / global_flops if global_flops > 0 else 0.0,
        collectives=coll)


def analyze_traced(counter, chips, model_flops_global, **kw) -> Roofline:
    """The roofline of one rank's traced step (an ``OpCounter``): the
    port's ``analyze_compiled``."""
    return roofline_terms(counter.flops, counter.bytes, counter.collectives, chips,
                          model_flops_global, **kw)
