"""The tile planner shared by the sorted-tile kernels (the edge megakernel,
edge_reduce and stratified_stats) and the budget of their record scratch.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``);
what they are handed is decided here, in Python, and holds on the CPU: the
tiles cover the window, no tile holds more tuples than a block sorts, past
one wave the tiles fill whole waves of resident blocks, and the plan depends
on the window's length and the card's resident blocks alone, so a session
step and ``execute`` on the same window sum in the same order.
"""

import pytest

from repro_torch.kernels.tiling import (MEGA_TILE, MIN_TILE, RECORD_BUDGET, plan_tiles,
                                        record_words)

SIZES = [1, 7, 1023, 1024, 1025, 8191, 8192, 8193, 130_000, 200_000, 8192 * 132 + 17,
         1_200_000, 5_000_001]
RESIDENT = [1, 8, 114, 132]


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("n", SIZES)
def test_plan_covers_the_window_in_whole_waves(n, resident):
    tiles, per = plan_tiles(n, resident)
    assert tiles * per >= n  # every tuple lies in a tile
    assert 1 <= per <= MEGA_TILE  # no tile holds more than a block sorts
    assert per == -(-n // tiles)  # the tuples spread evenly
    if tiles > resident:
        assert tiles % resident == 0  # whole waves past one wave
    # one wave is filled while a tile keeps MIN_TILE tuples
    assert tiles >= min(resident, -(-n // MIN_TILE))


@pytest.mark.parametrize("resident", RESIDENT)
def test_plan_depends_on_length_and_resident_blocks_alone(resident):
    first = [plan_tiles(n, resident) for n in SIZES]
    assert [plan_tiles(n, resident) for n in reversed(SIZES)] == first[::-1]


def test_empty_window_has_no_tiles():
    assert plan_tiles(0, 132) == (0, 0)


def test_main_path_plan_and_records():
    """The 1.2 M-tuple Shenzhen window on 132 SMs: two waves of 132 tiles,
    and edge_reduce's records at S 6558, C 2 take about 76 MB."""
    assert plan_tiles(1_200_000, 132) == (264, 4546)
    marker_words, words = record_words(264, 6558, 2)
    assert 2 * marker_words >= 264 * 6558
    assert words == marker_words + 264 * 6558 * 5
    assert 75e6 < 8 * words < 77e6


@pytest.mark.parametrize("columns", [1, 2, 8])
def test_records_above_the_budget_are_refused(columns):
    slots = RECORD_BUDGET // (264 * 8 * (1 + 2 * columns)) + 1
    with pytest.raises(ValueError, match=f"264 tiles x {slots} slots"):
        record_words(264, slots, columns)
    record_words(264, slots // 2, columns)
