"""The choice of MSDA kernels by shape (multi_modal_tracking_torch.ops.msda
msda_plan): K3 stages one (b, m) value slice per block where the blocks
fill the card and the slice fits in shared memory, else it gathers; K4
stages each level whose value slice and dValue accumulator fit, and sends
the others to its direct kernel. Nothing is launched here: the plan is
plain Python, read before every launch on the GPU."""
import os
import re

import pytest

from multi_modal_tracking_torch.ops import _build
from multi_modal_tracking_torch.ops.msda import (BWD_TABLE_BYTES, FWD_TABLE_BYTES, SMEM_MAX,
                                                 msda_plan)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

H100_SMS = 132
RECIPE = ((18, 18), (18, 18))      # the fusion's two modal 18x18 maps
M = 8


def test_tracking_shape_gathers_forward_and_stages_backward():
    plan = msda_plan(1, M, 64, RECIPE, H100_SMS)
    assert plan.fwd == "gather" and plan.fwd_smem == 0     # 8 (b, m) blocks cannot fill 132 SMs
    assert plan.bwd == ("staged", "staged")
    assert plan.bwd_smem == 2 * 18 * 18 * 64 * 4 + BWD_TABLE_BYTES == 169_984


def test_training_shape_stages_both():
    plan = msda_plan(16, M, 64, RECIPE, H100_SMS)
    assert plan.fwd == "staged"
    assert plan.fwd_smem == 648 * 64 * 4 + FWD_TABLE_BYTES == 174_080
    assert plan.bwd == ("staged", "staged")
    assert plan.bwd_smem == 169_984


def test_level_too_large_for_shared_memory_goes_direct():
    # 24x24 = 576 > 446 rows at D 64: 2 * 576 * 64 * 4 + 4096 = 299,008 B
    plan = msda_plan(16, M, 64, ((18, 18), (24, 24)), H100_SMS)
    assert plan.bwd == ("staged", "direct")
    assert plan.bwd_smem == 169_984                         # the staged level's only
    assert plan.fwd == "gather" and plan.fwd_smem == 0      # 900 rows > 876
    plan = msda_plan(16, M, 64, ((18, 18), (20, 20)), H100_SMS)   # 724 rows
    assert plan.fwd == "staged" and plan.fwd_smem == 724 * 64 * 4 + FWD_TABLE_BYTES
    plan = msda_plan(16, M, 64, ((32, 32),), H100_SMS)  # 1024 rows: nothing fits
    assert plan.fwd == "gather" and plan.fwd_smem == 0
    assert plan.bwd == ("direct",) and plan.bwd_smem == 0


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_largest_staged_level_at_each_width(D):
    rows = (SMEM_MAX - BWD_TABLE_BYTES) // (2 * 4 * D)      # 446 rows at D 64
    fits = msda_plan(16, M, D, ((1, rows),), H100_SMS)
    over = msda_plan(16, M, D, ((1, rows + 1),), H100_SMS)
    assert fits.bwd == ("staged",)
    assert fits.bwd_smem == 8 * rows * D + BWD_TABLE_BYTES <= SMEM_MAX
    assert over.bwd == ("direct",) and over.bwd_smem == 0
    rows = (SMEM_MAX - FWD_TABLE_BYTES) // (4 * D)          # 876 rows at D 64
    assert msda_plan(16, M, D, ((1, rows),), H100_SMS).fwd == "staged"
    assert msda_plan(16, M, D, ((1, rows + 1),), H100_SMS).fwd == "gather"


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("B", [1, 2, 16, 64])
@pytest.mark.parametrize("shapes", [RECIPE, ((9, 12), (5, 7)), ((6, 7), (5, 4), (3, 3)),
                                    ((18, 18), (24, 24)), ((40, 40), (20, 20), (10, 10))])
def test_shared_memory_within_the_h100_budget(D, B, shapes):
    plan = msda_plan(B, M, D, shapes, H100_SMS)
    assert 0 <= plan.fwd_smem <= SMEM_MAX and 0 <= plan.bwd_smem <= SMEM_MAX
    assert (plan.fwd_smem > 0) == (plan.fwd == "staged")
    assert (plan.bwd_smem > 0) == ("staged" in plan.bwd)
    for (h, w), path in zip(shapes, plan.bwd):       # every D here is even
        assert (path == "staged") == (8 * h * w * D + BWD_TABLE_BYTES <= SMEM_MAX)
        if path == "staged":
            assert 8 * h * w * D + BWD_TABLE_BYTES <= plan.bwd_smem


def test_odd_width_backward_goes_direct():
    """K4's staged kernel holds channel pairs, so an odd D goes direct;
    K3's staged kernel takes any D."""
    plan = msda_plan(16, M, 33, RECIPE, H100_SMS)
    assert plan.bwd == ("direct", "direct") and plan.bwd_smem == 0
    assert plan.fwd == "staged"


def test_forward_stages_once_the_blocks_fill_half_the_card():
    assert msda_plan(8, M, 64, RECIPE, H100_SMS).fwd == "gather"     # 64 blocks
    assert msda_plan(9, M, 64, RECIPE, H100_SMS).fwd == "staged"     # 72 blocks


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def test_kernels_share_the_budget_and_the_corner_header():
    """The CUDA side checks the same shared-memory budget and reserves the
    same corner tables, and both MSDA kernels take their corner arithmetic
    from one header."""
    assert re.search(r"SMEM_MAX = (\d+);", _source("msda_common.cuh")).group(1) == str(SMEM_MAX)
    for name, table_bytes in (("msda.cu", FWD_TABLE_BYTES), ("msda_bwd.cu", BWD_TABLE_BYTES)):
        src = _source(name)
        assert '#include "msda_common.cuh"' in src
        warps = int(re.search(r"STAGED_WARPS = (\d+);", src).group(1))
        entries = int(re.search(r"TABLE_BYTES = STAGED_WARPS \* (\d+) \* 8;", src).group(1))
        assert warps * entries * 8 == table_bytes
