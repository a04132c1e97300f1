"""The dry-run on a fake (2, 2, 2) ("pod", "data", "model") mesh: reduced
configs of each family for train, prefill and decode, held to the
reference's keys, specs and formulas as ``tests/test_torch_dryrun.py``
holds the (4, 2) rows (in a subprocess of its own, beside that file's)."""

from test_torch_dryrun import check_rows, dryrun_rows


def test_every_family_traces_train_prefill_and_decode_on_2x2x2():
    """4 agents over ("pod", "data") in full mode (2 x 2);
    the MoE decode is the recorded refusal of the multi-pod layout."""
    by = check_rows(dryrun_rows("2x2x2")["rows"], {"pod": 2, "data": 2, "model": 2})
    assert [k for k, r in by.items() if "refused" in r] == [("granite-moe-3b-a800m",
                                                             "decode_32k")]
    assert by[("llama3.2-1b", "train_4k")]["n_agents"] == 4
