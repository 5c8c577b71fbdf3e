"""The parent/change turn script of the main path's figures (CPU).

`scripts/ab_main_path.py` runs only on the card; here its turn script is
compiled and its summary checked on made-up turns.
"""

import pytest

pytest.importorskip("torch")
from rustsasa_tpu_torch.scripts import ab_main_path


def _turn(scale):
    groups = {group for group, _key in ab_main_path.FIGURES}
    rec = {group: {} for group in groups}
    for i, (group, key) in enumerate(ab_main_path.FIGURES):
        rec[group][key] = scale * (i + 1)
    rec.update(gpu_name="card", power_limit="700.00 W", cpu_count=8)
    return rec


def test_turn_script_compiles():
    compile(ab_main_path.TURN_SCRIPT, "turn_script", "exec")


def test_summary_gives_each_tree_in_turn_order():
    turns = [("A", _turn(2.0)), ("B", _turn(1.0)), ("B", _turn(1.0)),
             ("A", _turn(4.0))]
    lines = ab_main_path.summary(turns)
    assert len(lines) == len(ab_main_path.FIGURES) + 1
    assert lines[0] == ("stages_05m.dequant_ms: A [2.0, 4.0] B [1.0, 1.0]; "
                        "medians 3 -> 1")
    assert lines[-1] == "on card, 700.00 W, 8 host cores"


def test_list_turn_script_compiles():
    compile(ab_main_path.LIST_TURN_SCRIPT, "list_turn_script", "exec")


def test_list_summary_gives_each_list_figure():
    def rec(scale):
        out = {group: {} for group, _key in ab_main_path.LIST_FIGURES}
        for i, (group, key) in enumerate(ab_main_path.LIST_FIGURES):
            out[group][key] = scale * (i + 1)
        out.update(gpu_name="card", power_limit="700.00 W", cpu_count=8)
        return out

    turns = [("A", rec(3.0)), ("B", rec(1.0)), ("B", rec(1.0)),
             ("A", rec(3.0))]
    lines = ab_main_path.summary(turns, ab_main_path.LIST_FIGURES)
    assert len(lines) == len(ab_main_path.LIST_FIGURES) + 1
    assert lines[0] == ("phase.graph_ms: A [3.0, 3.0] B [1.0, 1.0]; "
                        "medians 3 -> 1")
    assert lines[-1] == "on card, 700.00 W, 8 host cores"


def test_study_turn_script_compiles_and_summarizes():
    compile(ab_main_path.STUDY_TURN_SCRIPT, "study_turn_script", "exec")

    def rec(scale):
        out = {group: {} for group, _key in ab_main_path.STUDY_FIGURES}
        for i, (group, key) in enumerate(ab_main_path.STUDY_FIGURES):
            out[group][key] = scale * (i + 1)
        out.update(gpu_name="card", power_limit="700.00 W", cpu_count=8)
        return out

    turns = [("A", rec(2.0)), ("B", rec(1.0))]
    lines = ab_main_path.summary(turns, ab_main_path.STUDY_FIGURES)
    assert len(lines) == len(ab_main_path.STUDY_FIGURES) + 1
    assert lines[0] == "k1_05m.ms: A [2.0] B [1.0]; medians 2 -> 1"
    assert lines[2] == "sat_05m.sat1: A [6.0] B [3.0]; medians 6 -> 3"
    groups = {group for group, _key in ab_main_path.STUDY_FIGURES}
    assert {"reach_05m", "reach_2m", "pair_05m", "pair_2m"} <= groups
    assert ("pair_2m", "nibble") in ab_main_path.STUDY_FIGURES
