"""The harness is driven by data: every cell's files are found by name, and
the harness's own source names no configuration, mix, loop or metric."""

import json
from pathlib import Path

import pytest

from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _names():
    out = {w["traffic"] for w in SPEC["workloads"]} | {c["name"] for c in SPEC["configs"]}
    out |= {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    out |= {p.stem for p in (BENCH / "loops").glob("*.py")}
    return out


@pytest.mark.parametrize("name", sorted(_names()))
def test_harness_names_no_cell_part(name):
    for path in (BENCH / "harness.py", BENCH / "run.py"):
        assert f'"{name}"' not in path.read_text(), (path.name, name)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_part_of_a_cell_has_its_file(cell):
    c = harness.load_cell(cell)
    assert callable(harness.loop(c).Program)
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"])), m["name"]
    assert (BENCH / "data" / f"{c.config['graph']['generator']}.py").is_file()
