"""Small copies of the cells for the CPU tests."""

import time

import torch

from perfbench import harness

CELLS = ("rgg500k_p100.async", "rgg500k_p100_dp.async", "rgg500k_p100.sync",
         "rgg500k_p100.async_delay")
SEED = 2**33 + 1234567


def small_cell(name: str):
    """``name`` at n = 4096 with 512 expected wakes a slot, short calls and
    twelve checked slots (episodes of T_i's expected length)."""
    traffic = {"call_slots": 16}
    cell = harness.load_cell(name, {"n": 4096, "slot_wakes": 512.0}, traffic)
    if cell.traffic["loop"] == "async_engine":
        cell.traffic["check"] = dict(cell.traffic["check"], points=12)
        cell.traffic["fused"] = True if not cell.traffic.get("delay") else False
        if cell.traffic.get("episode_slots"):
            cell.traffic.update(episode_slots=96, trace_calls=6)
    return cell


def run(name: str, traced: bool = False, controls: bool = False, seconds: float = 0.5):
    torch.manual_seed(0)
    return harness.run_cell(small_cell(name), SEED, seconds, traced, "cpu", time.perf_counter(),
                            controls=controls)
