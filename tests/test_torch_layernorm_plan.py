"""B6's row plan (`vjepa2_tpu_torch/ops/layernorm.py:ln_row_plan`) on the
CPU: how the persistent LayerNorm kernels (the forward with an output and
the backward, `csrc/ln_common.cuh`, `csrc/layernorm.cu`) split R rows of
width C over a card of a given SM count, and which lanes of a warp hold a
row. The kernels take the plan's `rows_per_block` from their wrapper; their
lane groups are compile-time constants that `tests/test_torch_ln_cuda.py`
holds against the plan on the card. Needs no JAX and no GPU.

Rows: 1, 7 and 100 (fewer than the blocks the card could hold), 1003
(ragged), and the main path's 1408, 4672, 12992, 13312 and 16384; SM counts
1, 114 (an H100 PCIe) and 132 (an H100 SXM).
"""

import pytest

from vjepa2_tpu_torch.ops import layernorm as tln

ROWS = [1, 7, 100, 1003, 1408, 4672, 12992, 13312, 16384]
SMS = [1, 114, 132]


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_every_row_falls_in_one_contiguous_range(C, R):
    """Block b takes rows [b * rows_per_block, min(R, (b + 1) *
    rows_per_block)): together the ranges are the rows in order, each row
    once; no block is empty; at most two blocks an SM and one a row (more
    only where a block would take more than `LN_MAX_BLOCK_ROWS`), and at
    least one an SM where there are rows for it; the backward's partial rows,
    one a block, number the grid, which is the kernels' own ceil(R /
    rows_per_block)."""
    for sms in SMS:
        plan = tln.ln_row_plan(R, C, sms)
        ranges = [range(b * plan.rows_per_block, min(R, (b + 1) * plan.rows_per_block))
                  for b in range(plan.grid)]
        assert [r for rng in ranges for r in rng] == list(range(R))
        assert all(len(rng) > 0 for rng in ranges)
        assert plan.rows_per_block <= tln.LN_MAX_BLOCK_ROWS
        full = min(R, tln.LN_BLOCKS_PER_SM * sms)
        assert plan.grid <= max(full, -(-R // tln.LN_MAX_BLOCK_ROWS))
        assert plan.grid >= full // 2
        assert plan.grid == -(-R // plan.rows_per_block)


@pytest.mark.parametrize("C", tln.LN_WIDTHS)
def test_lane_groups_leave_no_lane_idle(C):
    """C / 8 chunks of 16 bytes: 384 as 16 lanes x 3 (two rows a warp), 1024
    as 32 x 4, 1280 as 32 x 5, with no lane idle on a last chunk; 1408 as 32
    x 6 with the sixth chunk on half the lanes (the rule `csrc/ln_common.cuh`
    states, 16 x 11 having measured slower)."""
    chunks = C // 8
    lanes, per_lane = {384: (16, 3), 1024: (32, 4), 1280: (32, 5), 1408: (32, 6)}[C]
    plan = tln.ln_row_plan(1003, C, 132)
    assert (plan.lanes, plan.per_lane) == (lanes, per_lane) and tln.ln_lanes(C) == lanes
    assert 32 % lanes == 0
    if C != 1408:
        assert lanes * per_lane == chunks
    else:
        assert lanes * (per_lane - 1) + lanes // 2 == chunks


def test_plan_depends_only_on_rows_width_and_sm_count():
    """The same arguments give the same plan; the grid follows the SM count
    (which is why dgamma/dbeta round otherwise on another card), and the
    lane groups do not."""
    plans = {(R, C, sms): tln.ln_row_plan(R, C, sms)
             for R in ROWS for C in tln.LN_WIDTHS for sms in SMS}
    tln.ln_row_plan.cache_clear()
    for (R, C, sms), plan in plans.items():
        assert tln.ln_row_plan(R, C, sms) == plan
        assert plan[2:] == plans[(ROWS[0], C, SMS[0])][2:]
    assert plans[(16384, 1024, 114)].grid != plans[(16384, 1024, 132)].grid
    # 1408 rows (the 176-token context) fill every SM
    assert plans[(1408, 1024, 132)].grid >= 132


@pytest.mark.parametrize("R,C,sms", [(0, 1024, 132), (16, 512, 132), (16, 1024, 0)])
def test_plan_refuses_what_the_kernels_do_not_take(R, C, sms):
    with pytest.raises(ValueError):
        tln.ln_row_plan(R, C, sms)
