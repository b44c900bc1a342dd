"""The fused MLP's host plan (``ops/weight_phases.py`` ``mlp_plan``), on the
CPU: the megakernel's list of work items with no QKV product, whose items
of wo, gate/up and down cover every output column and contraction row
exactly once; a block's shared memory within the card's limit; the ring
holding every stage of a block's items up to 16 rows at qwen3guard-0.6b's
width and running ahead past them; the workspace holding what the items
write; and the wrapper launching with the plan, the three maps and the
shared workspace.
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu_torch.ops import fused_mlp as FM
from cmw_rag_tpu_torch.ops import weight_phases as WP

#: (D, A, F): qwen3guard-0.6b, and the card tests' small widths (F 192:
#: half a column tile; A 128: a contraction of two stages)
WIDTHS = [(1024, 2048, 3072), (256, 512, 384), (256, 128, 192),
          (64, 64, 128)]
ROWS = [1, 3, 4, 8, 9, 16, 17, 32, 33, 40, 64, 255, 256]
#: a block's shared memory on sm_90 (static and dynamic together)
SM90_BLOCK_SMEM = 232448


def _covered(plan, s, d, a, f):
    """Per product (wo, gate/up, down), how often each (row, output
    column, block of 64 contraction rows) is computed by the items."""
    shapes = {1: (d, a), 2: (2 * f, d), 3: (d, f)}
    counts = {pr: np.zeros((s, n, k // WP.LAYER_ROWS), dtype=np.int64)
              for pr, (n, k) in shapes.items()}
    for pr, mt, ct, _, s0, s1 in WP.layer_items(plan):
        assert pr in counts, "the fused MLP has no QKV item"
        q = plan.products[pr]
        rows = slice(mt * plan.mt, min(s, (mt + 1) * plan.mt))
        for b in range(q.nb):
            c0 = ct * WP.LAYER_COLS + b * q.box_off
            # gate/up: a gate tile's columns stop at F, an up tile's at 2F
            hi = q.n if q.nb == 2 and b == 0 else shapes[pr][0]
            cols = slice(c0, min(hi, c0 + WP.LAYER_COLS))
            counts[pr][rows, cols, s0:s1] += 1
    return counts


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("s", ROWS)
@pytest.mark.parametrize("blocks", [132, 114, 7])
def test_items_cover_every_column_and_contraction_row_once(width, s, blocks):
    d, a, f = width
    plan = WP.mlp_plan(s, d, a, f, blocks)
    assert plan.products[0] == WP.NO_PRODUCT
    for pr, c in _covered(plan, s, *width).items():
        assert (c == 1).all(), (pr, c.min(), c.max())
    for q in plan.products[1:]:
        assert 1 <= q.ks <= q.steps
        # an item's activations fit the kernel's 1024 contraction rows
        assert -(-q.steps // q.ks) * WP.LAYER_ROWS <= WP.LAYER_KCAP


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("s", ROWS)
def test_shared_memory_fits_a_block_at_every_row_tile(width, s):
    plan = WP.mlp_plan(s, *width, 132)
    assert plan.mt == WP.layer_tile(s) and plan.mt in (8, 16)
    assert plan.mtiles == -(-s // plan.mt)
    assert 2 <= plan.ring <= WP.layer_max_ring(plan.mt)
    assert plan.smem == WP.layer_smem(plan.mt, plan.ring)
    # the static shared memory (ring barriers, row norms, the plan) is
    # under the 1 KB the plan leaves it
    assert plan.smem + 8 * WP.LAYER_MAX_RING + 4 * 16 + 4 + 4 * 32 \
        <= SM90_BLOCK_SMEM
    # the ring holds the busiest block's stages, or as many as fit
    assert plan.ring == max(2, min(max(WP.layer_block_stages(plan)),
                                   WP.layer_max_ring(plan.mt)))


@pytest.mark.parametrize("s", [1, 4, 8, 9, 16])
def test_every_stage_is_in_flight_from_entry_up_to_16_rows(s):
    """At qwen3guard-0.6b's width the ring holds all of the busiest block's
    stages (11 MB of weights over 132 blocks: 13 stages at most)."""
    plan = WP.mlp_plan(s, 1024, 2048, 3072, 132)
    stages = WP.layer_block_stages(plan)
    assert sum(stages) == 8 * 32 + 2 * 24 * 16 + 8 * 48
    assert max(stages) <= plan.ring == 13
    assert [q.ks for q in plan.products] == [1, 16, 5, 16]
    for q in plan.products[1:]:
        assert q.ctiles * q.ks <= 132     # each product fills the grid once


@pytest.mark.parametrize("s", [32, 40, 64, 256])
def test_past_two_row_tiles_the_ring_runs_ahead(s):
    plan = WP.mlp_plan(s, 1024, 2048, 3072, 132)
    assert plan.ring == WP.layer_max_ring(16) < max(
        WP.layer_block_stages(plan))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("s", [1, 8, 16, 17, 40, 256])
def test_workspace_holds_what_the_items_write(width, s):
    d, a, f = width
    plan = WP.mlp_plan(s, d, a, f, 132)
    (part, h, x1), counts = FM.mlp_workspace(plan, s, d, f)
    assert all(n % 4 == 0 for n in (part, h, x1))     # 16-byte aligned
    for q in plan.products:
        if q.ks > 1:
            assert part >= (plan.mtiles * q.ctiles * q.ks * plan.mt * q.nb
                            * WP.LAYER_COLS)
    assert 2 * h >= s * f and x1 >= s * d
    assert counts == max(plan.mtiles * q.ctiles for q in plan.products[1:])


def test_the_wrapper_launches_with_the_plan(monkeypatch):
    """``_launch`` passes the plan's splits, ring and grid, the three maps
    (wo, gate/up, down) and the shared workspace's buffers and counters
    to the C entry (recorded here in place of the library, with CPU
    tensors standing in for the card's); a second call makes no new
    workspace."""
    calls = []

    class Lib:
        @staticmethod
        def fused_mlp_int8(*args):
            calls.append(args)
            return 0

        @staticmethod
        def fused_mlp_encode(ptr, k, n, buf):
            buf[:4] = np.int32(k * 100000 + n).tobytes()
            return 0

    class Dev:
        def __init__(self, *a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Stream:
        cuda_stream = 11

    monkeypatch.setattr(FM, "_lib", lambda: Lib)
    monkeypatch.setattr(FM, "_grid", lambda dev, mt: 132)
    monkeypatch.setattr(WP, "_MAPS", {})
    monkeypatch.setattr(WP, "_WORKSPACES", {})
    monkeypatch.setattr(torch.cuda, "device", Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    s, d, a, f = 40, 256, 128, 192
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((s, d), generator=gen).bfloat16()
    attn = torch.randn((s, a), generator=gen).bfloat16()
    ws = (torch.zeros((a, d), dtype=torch.int8), torch.ones(d), torch.ones(d),
          torch.zeros((d, 2 * f), dtype=torch.int8), torch.ones(2 * f),
          torch.zeros((f, d), dtype=torch.int8), torch.ones(d))
    out = FM._launch(x, attn, *ws, 1e-6)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    FM._launch(x, attn, *ws, 1e-6)
    assert len(calls) == 2
    args = calls[0]
    plan = WP.mlp_plan(s, d, a, f, 132)
    assert args[6:10] == (s, d, a, f) and args[10] == 1e-6
    assert list(args[11:14]) == [q.ks for q in plan.products[1:]]
    assert args[-3:] == (plan.ring, plan.grid, 11)
    maps = bytes(args[18])
    assert len(maps) == 3 * 128
    assert [int(np.frombuffer(maps[128 * i:128 * i + 4], np.int32)[0])
            for i in range(3)] == [a * 100000 + d, d * 100000 + 2 * f,
                                   f * 100000 + d]
    floats, counts = WP._WORKSPACES[(None, 11)]
    sizes, n_counts = FM.mlp_workspace(plan, s, d, f)
    base = floats.data_ptr()
    assert list(args[14:17]) == [base, base + 4 * sizes[0],
                                 base + 4 * (sizes[0] + sizes[1])]
    assert floats.numel() >= sum(sizes) and counts.numel() >= n_counts
    assert args[19] == counts.data_ptr()
    # the second call found the same workspace and the cached maps
    assert calls[1][14:17] == args[14:17] and calls[1][19] == args[19]
    assert len(WP._MAPS) == 3
