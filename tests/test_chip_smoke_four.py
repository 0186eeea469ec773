"""chip_smoke.py --four-cards on four of the virtual CPU devices at tiny
sizes: tile16 ring, element column shard, macro ring and DIA halo, each
against the one-card result and scipy."""

import chip_smoke as cs


def test_four_card_decompositions_tiny():
    recs = cs.run_four_cards("tiny", n_devices=4)
    assert [r["phase"] for r in recs] == [
        "four:tile16-ring", "four:element-column-shard", "four:macro-ring",
        "four:dia-halo"]
    for r in recs:
        assert r["ok"], r
        assert r["c_nnz"] == r["c_nnz_host"] == r["c_nnz_one_card"]
