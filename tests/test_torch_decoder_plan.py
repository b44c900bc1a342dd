"""The decoder-layer megakernel's host plan (``ops/weight_phases.py``
``layer_plan``), on the CPU: the work items of the four weight products
(QKV, wo, gate/up, down) cover every output column and contraction row
exactly once, a block's shared memory fits the card's per-block limit at
every row tile and head dim, the ring holds every stage of a block's items
up to 16 rows at qwen3guard-0.6b's width, the workspace holds what the
items write, and the wrapper launches with the plan.
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu_torch.ops import decoder_layer as DL
from cmw_rag_tpu_torch.ops import paged_attention as PA
from cmw_rag_tpu_torch.ops import weight_phases as WP

#: (D, Hq, Hkv, Dh, F): qwen3guard-0.6b, and the small widths of the tests
WIDTHS = [(1024, 16, 8, 128, 3072), (256, 8, 2, 64, 384),
          (128, 2, 2, 64, 192), (64, 4, 4, 64, 128)]
ROWS = [1, 3, 4, 8, 9, 16, 17, 32, 33, 64, 255, 256]
#: a block's shared memory on sm_90 (static and dynamic together)
SM90_BLOCK_SMEM = 232448


def _covered(plan, s, d, hq, hkv, dh, f):
    """Per product, how often each (row, output column, contraction row)
    block of 64 contraction rows is computed by the plan's items."""
    a3, a = (hq + 2 * hkv) * dh, hq * dh
    shapes = [(a3, d), (d, a), (2 * f, d), (d, f)]
    counts = [np.zeros((s, n, k // WP.LAYER_ROWS), dtype=np.int64)
              for n, k in shapes]
    for pr, mt, ct, _, s0, s1 in WP.layer_items(plan):
        q = plan.products[pr]
        rows = slice(mt * plan.mt, min(s, (mt + 1) * plan.mt))
        for b in range(q.nb):
            c0 = ct * WP.LAYER_COLS + b * q.box_off
            # gate/up: a gate tile's columns stop at F, an up tile's at 2F
            hi = (q.n if q.nb == 2 and b == 0 else shapes[pr][0])
            cols = slice(c0, min(hi, c0 + WP.LAYER_COLS))
            counts[pr][rows, cols, s0:s1] += 1
    return counts


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("s", ROWS)
@pytest.mark.parametrize("blocks", [132, 114, 7])
def test_items_cover_every_column_and_contraction_row_once(width, s, blocks):
    d, hq, hkv, dh, f = width
    plan = WP.layer_plan(s, d, hq, hkv, dh, f, blocks)
    for name, c in zip(("qkv", "wo", "gate/up", "down"),
                       _covered(plan, s, *width)):
        assert (c == 1).all(), (name, c.min(), c.max())
    for q in plan.products:
        assert 1 <= q.ks <= q.steps
        # an item's activations fit the kernel's 1024 contraction rows
        assert -(-q.steps // q.ks) * WP.LAYER_ROWS <= WP.LAYER_KCAP


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s", ROWS)
def test_shared_memory_fits_a_block_at_every_row_tile(dh, s):
    d, hq, hkv, f = 1024, 16, 8, 3072
    if dh == 64:
        hq, hkv = 32, 16
    plan = WP.layer_plan(s, d, hq, hkv, dh, f, 132)
    assert plan.mt == WP.layer_tile(s) and plan.mt in (8, 16)
    assert 2 <= plan.ring <= WP.layer_max_ring(plan.mt) <= WP.LAYER_MAX_RING
    assert plan.smem == WP.layer_smem(plan.mt, plan.ring)
    # the kernel's static shared memory (ring barriers, row norms) is
    # under the 1 KB the plan leaves it
    assert plan.smem + 8 * WP.LAYER_MAX_RING + 4 * 32 + 4 <= SM90_BLOCK_SMEM
    assert WP.layer_smem(plan.mt, WP.layer_max_ring(plan.mt)) \
        <= WP.LAYER_SMEM_LIMIT
    # attention's scratch (attend_split) fits the activations and tile
    # buffer at the smallest row tile
    att = 4 * (8 * dh + 8 * 128 + 3 * 8 + (256 // (dh // 8)) * dh)
    assert att <= WP.layer_smem(8, 0) - 1024


@pytest.mark.parametrize("s", [1, 4, 8, 9, 16])
def test_every_stage_is_in_flight_from_entry_up_to_16_rows(s):
    """At qwen3guard-0.6b's width the ring holds all of the busiest block's
    stages: nothing waits on a refill."""
    plan = WP.layer_plan(s, 1024, 16, 8, 128, 3072, 132)
    stages = WP.layer_block_stages(plan)
    assert sum(stages) == plan.mtiles * (
        32 * 16 + 8 * 32 + 2 * 24 * 16 + 8 * 48)
    assert max(stages) <= plan.ring
    assert [q.ks for q in plan.products] == [4, 16, 5, 16]
    # each product about fills the grid once
    for q in plan.products:
        assert q.ctiles * q.ks <= 132


@pytest.mark.parametrize("s", [32, 64, 256])
def test_past_16_rows_the_ring_runs_ahead(s):
    plan = WP.layer_plan(s, 1024, 16, 8, 128, 3072, 132)
    assert plan.ring == WP.layer_max_ring(16) < max(
        WP.layer_block_stages(plan))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("s", [1, 8, 16, 33, 256])
def test_workspace_holds_what_the_items_write(width, s):
    d, hq, hkv, dh, f = width
    plan = WP.layer_plan(s, d, hq, hkv, dh, f, 132)
    sizes, counts = DL.layer_workspace(plan, s, d, hq, hkv, dh, f)
    part, h, qbuf, aout, x1 = sizes
    assert all(n % 4 == 0 for n in sizes)            # 16-byte aligned
    for q in plan.products:
        if q.ks > 1:
            assert part >= (plan.mtiles * q.ctiles * q.ks * plan.mt * q.nb
                            * WP.LAYER_COLS)
    assert 2 * h >= s * f and qbuf >= s * hq * dh and aout >= s * hq * dh
    assert x1 >= s * d
    assert counts == (max(plan.mtiles * q.ctiles for q in plan.products)
                      + plan.mtiles * hkv)


def test_launch_config_uses_the_plan_and_the_split_scratch():
    d, hq, hkv, dh, f, page = 1024, 16, 8, 128, 3072, 64
    plan, sizes, n_split, n_attn, n_counts = DL.launch_config(
        4, d, hq, hkv, dh, f, page, 6, 132)
    assert plan == WP.layer_plan(4, d, hq, hkv, dh, f, 132)
    assert sizes == DL.layer_workspace(plan, 4, d, hq, hkv, dh, f)[0]
    want_split, shape, n_att_counts = PA.split_scratch(
        4, hkv, hq // hkv, dh, 6 * page, PA.ATTN_SPLIT)
    assert n_split == want_split
    assert n_attn >= int(np.prod(shape)) and n_attn % 4 == 0
    assert n_counts == (DL.layer_workspace(plan, 4, d, hq, hkv, dh, f)[1]
                        + n_att_counts)


def test_the_wrapper_launches_with_the_plan(monkeypatch):
    """``_launch`` passes the plan's splits, ring and grid, the four maps
    and the workspace's counters to the C entry (recorded here in place of
    the library, with CPU tensors standing in for the card's)."""
    calls = {}

    def fake_entry(kv8, which):
        if which == "layer":
            def layer(*args):
                calls["args"] = args
                return 0
            return layer
        raise AssertionError(which)

    monkeypatch.setattr(DL, "_entry", fake_entry)
    monkeypatch.setattr(DL, "_grid", lambda dev, mt, dh, kv8: 132)
    monkeypatch.setattr(DL, "_weight_maps",
                        lambda kv8, ws: calls.setdefault("maps", ws))

    class Dev:
        def __init__(self, *a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "device", Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    s, d, hq, hkv, dh, f, page, maxp = 4, 256, 8, 2, 64, 384, 16, 4
    gen = torch.Generator().manual_seed(0)
    a3 = (hq + 2 * hkv) * dh
    weights = (torch.ones(d), torch.zeros((d, a3), dtype=torch.int8),
               torch.ones(a3), torch.ones(dh), torch.ones(dh),
               torch.zeros((hq * dh, d), dtype=torch.int8), torch.ones(d),
               torch.ones(d), torch.zeros((d, 2 * f), dtype=torch.int8),
               torch.ones(2 * f), torch.zeros((f, d), dtype=torch.int8),
               torch.ones(d))
    x = torch.randn((s, d), generator=gen).bfloat16()
    c2 = s2 = torch.zeros((s, dh))
    pools = torch.zeros((2, 1 + s * maxp, page, hkv, dh),
                        dtype=torch.bfloat16)
    ints = torch.zeros((s,), dtype=torch.int32)
    tables = torch.zeros((s, maxp), dtype=torch.int32)
    DL._launch(x, c2, s2, weights, ints, ints, pools, pools, ints, 1,
               tables, None, 1e-6, "")
    args = calls["args"]
    plan = WP.layer_plan(s, d, hq, hkv, dh, f, 132)
    assert list(args[34:38]) == [q.ks for q in plan.products]
    assert args[-3:-1] == (plan.ring, plan.grid)
    assert [w.shape for w in calls["maps"]] == [
        (d, a3), (hq * dh, d), (d, 2 * f), (f, d)]
