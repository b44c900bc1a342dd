"""The weight-only int8 matmul's host plan (``ops/weight_phases.py``
``matmul_plan``), on the CPU: the weight phases' list with one product, in
wo's slot, whose items cover every output column and contraction row
exactly once; splits that keep an item's activations within the kernel's
1024 rows; a block's shared memory within the card's limit; the ring
holding every stage of a block's items where it fits and running ahead
past them (the head); the workspace holding what the items write; the
wrapper launching with the plan, the map and the per-stream workspace; and
the kernel's tensor-core sums, on the model of ``tensor_core_model.py``,
within a stated share of the plain twin's.
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu_torch.ops import int8_matmul as IM
from cmw_rag_tpu_torch.ops import weight_phases as WP
import tensor_core_model as TC

#: (K, N): the card tests' shapes but the head's (N 16: under one column
#: tile; 1,040: past whole ones; K 3,072: past an item's 1,024 rows)
SHAPES = [(1024, 4096), (64, 16), (256, 1040), (128, 512), (3072, 1024)]
ROWS = [1, 4, 5, 8, 9, 16, 17, 32, 33]
#: a block's shared memory on sm_90 (static and dynamic together)
SM90_BLOCK_SMEM = 232448
#: the kernel's co-resident blocks on an H100: two on each of 132 SMs
SMS = 132
BLOCKS = 2 * SMS
#: the most the tensor cores' sums (on the model) may part from the plain
#: twin's, as a share of its largest |output|: a tenth of the card tests'
#: 1e-5 (INT8_MM_TOL), so that the model's own error leaves room
MODEL_GAP = 1e-6


def _covered(plan, m, k, n):
    """How often the items compute each (row, output column, block of 64
    contraction rows)."""
    counts = np.zeros((m, n, k // WP.LAYER_ROWS), dtype=np.int64)
    for pr, mt, ct, _, s0, s1 in WP.layer_items(plan):
        assert pr == 1, "the lone product takes wo's slot"
        rows = slice(mt * plan.mt, min(m, (mt + 1) * plan.mt))
        cols = slice(ct * WP.LAYER_COLS, min(n, (ct + 1) * WP.LAYER_COLS))
        counts[rows, cols, s0:s1] += 1
    return counts


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("blocks", [BLOCKS, 228, 14])
def test_items_cover_every_column_and_contraction_row_once(shape, m,
                                                           blocks):
    k, n = shape
    plan = WP.matmul_plan(m, k, n, blocks, blocks // 2)
    assert [p for i, p in enumerate(plan.products) if i != 1] == [
        WP.NO_PRODUCT] * 3
    c = _covered(plan, m, k, n)
    assert (c == 1).all(), (c.min(), c.max())


@pytest.mark.parametrize("shape", SHAPES + [(1024, 151680)])
@pytest.mark.parametrize("m", ROWS)
def test_splits_keep_an_item_within_1024_rows(shape, m):
    k, n = shape
    q = WP.matmul_plan(m, k, n, BLOCKS, SMS).products[1]
    steps = k // WP.LAYER_ROWS
    assert q.steps == steps and q.n == n and q.nb == 1
    assert -(-k // WP.LAYER_KCAP) <= q.ks <= steps
    assert -(-steps // q.ks) * WP.LAYER_ROWS <= WP.LAYER_KCAP


@pytest.mark.parametrize("shape", SHAPES + [(1024, 151680)])
@pytest.mark.parametrize("m", ROWS)
def test_two_blocks_fit_a_sm_and_the_grid_the_items(shape, m):
    plan = WP.matmul_plan(m, *shape, BLOCKS, SMS)
    q = plan.products[1]
    assert plan.mt == WP.layer_tile(m) and plan.mtiles == -(-m // plan.mt)
    assert 2 <= plan.ring <= WP.mm_max_ring(plan.mt)
    assert plan.smem == WP.layer_smem(plan.mt, plan.ring)
    # two blocks a SM: each its dynamic and static shared memory (the
    # ring's full and empty barriers, the plan, a flag) and the 1 KB the
    # card reserves a block
    assert 2 * (plan.smem + 16 * WP.LAYER_MAX_RING + 4 * 32 + 4 + 1024) \
        <= WP.SM_SMEM
    assert plan.grid == min(BLOCKS, plan.mtiles * q.ctiles * q.ks)
    # the ring holds the busiest block's stages, or as many as fit
    assert plan.ring == max(2, min(max(WP.layer_block_stages(plan)),
                                   WP.mm_max_ring(plan.mt)))


def test_the_engine_shapes():
    """qwen3guard-0.6b on 264 blocks (two on each of 132 SMs): the fused
    QKV splits 4 ways, one item a SM, all of its stages in flight from
    entry; the head does not split, and its ring (10 stages at 4 rows, 7
    at 16) runs ahead of the busiest block's 80; the unfused down product
    splits 16 ways."""
    for m in (4, 16):
        qkv = WP.matmul_plan(m, 1024, 4096, BLOCKS, SMS)
        assert qkv.products[1].ks == 4 and qkv.grid == 128
        assert max(WP.layer_block_stages(qkv)) == qkv.ring == 4
        head = WP.matmul_plan(m, 1024, 151680, BLOCKS, SMS)
        assert head.products[1].ks == 1 and head.grid == BLOCKS
        assert max(WP.layer_block_stages(head)) == 80
        assert head.ring == {4: 10, 16: 7}[m] == WP.mm_max_ring(head.mt)
    down = WP.matmul_plan(16, 3072, 1024, BLOCKS, SMS)
    assert down.products[1].ks == 16 and down.ring == 3 and down.grid == 128


@pytest.mark.parametrize("shape", SHAPES + [(1024, 151680)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 33])
def test_workspace_holds_what_the_items_write(shape, m):
    k, n = shape
    plan = WP.matmul_plan(m, k, n, BLOCKS, SMS)
    q = plan.products[1]
    floats, counts = IM.matmul_workspace(plan)
    if q.ks == 1:
        assert (floats, counts) == (0, 0)
        return
    tiles = plan.mtiles * q.ctiles
    assert floats == tiles * q.ks * plan.mt * WP.LAYER_COLS
    assert counts == tiles


def test_the_wrapper_launches_with_the_plan(monkeypatch):
    """``_launch`` passes the plan's split, ring and grid, the weight's map
    and the stream's workspace to the C entry (recorded here in place of
    the library, with CPU tensors standing in for the card's); a second
    call makes no new workspace and no new map; a product of one split
    takes no workspace."""
    calls = []

    class Lib:
        @staticmethod
        def int8_matmul(*args):
            calls.append(args)
            return 0

        @staticmethod
        def int8_matmul_encode(ptr, k, n, buf):
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

    monkeypatch.setattr(IM, "_lib", lambda: Lib)
    monkeypatch.setattr(IM, "_grid", lambda dev, mt, x_f32: BLOCKS)
    monkeypatch.setattr(IM, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(WP, "_MAPS", {})
    monkeypatch.setattr(WP, "_WORKSPACES", {})
    monkeypatch.setattr(torch.cuda, "device", Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    m, k, n = 16, 3072, 1024
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(0))
    wq, ws = torch.zeros((k, n), dtype=torch.int8), torch.ones(n)
    out = IM._launch(x, wq, ws)
    assert out.shape == (m, n) and out.dtype == torch.float32
    IM._launch(x, wq, ws)
    plan = WP.matmul_plan(m, k, n, BLOCKS, SMS)
    args = calls[0]
    assert args[1] == 1 and args[4:7] == (m, k, n)
    assert args[7:10] == (plan.products[1].ks, plan.ring, plan.grid) \
        == (16, 3, 128)
    assert int(np.frombuffer(bytes(args[2])[:4], np.int32)[0]) \
        == k * 100000 + n
    floats, counts = WP._WORKSPACES[(None, 11)]
    assert args[10:12] == (floats.data_ptr(), counts.data_ptr())
    assert args[-1] == 11
    words, n_counts = IM.matmul_workspace(plan)
    assert floats.numel() >= words and counts.numel() >= n_counts
    assert calls[1][10:12] == args[10:12] and len(WP._MAPS) == 1
    # the head's shape: one split, no workspace pointers
    IM._launch(x[:4, :1024].contiguous().bfloat16(),
               torch.zeros((1024, 151680), dtype=torch.int8),
               torch.ones(151680))
    assert calls[2][1] == 0 and calls[2][7] == 1
    assert calls[2][10:12] == (None, None)


@pytest.mark.parametrize("m,k,n,dtype", [
    (4, 1024, 256, torch.float32), (4, 1024, 256, torch.bfloat16),
    (16, 1024, 128, torch.float32), (16, 3072, 128, torch.float32),
    (33, 128, 512, torch.bfloat16)])
def test_tensor_core_sums_stay_within_the_stated_share(m, k, n, dtype):
    """The kernel's product on the tensor-core model (its splits as the
    plan gives them on an H100 at the engine's N: the head's one split at
    K 1,024, 16 at K 3,072) parts from the plain twin by at most
    ``MODEL_GAP`` of the largest |output| in float32, and by at most one
    bf16 step plus that where the output is bf16."""
    gen = torch.Generator().manual_seed(m + k + n)
    wq, ws = IM.quantize_weight(torch.randn((k, n), generator=gen) * 0.05)
    x = torch.randn((m, k), generator=gen).to(dtype)
    ks = WP.matmul_plan(m, k, {256: 151680, 128: 1024}.get(n, n), BLOCKS,
                        SMS).products[1].ks
    got = (TC.tensor_core_qkv(x.to(torch.bfloat16).float(), wq, ks)
           * ws[None, :]).to(dtype).float()
    want = IM.int8_matmul_plain(x, wq, ws).float()
    step = (TC.bf16_step(torch.maximum(got.abs(), want.abs()))
            if dtype == torch.bfloat16 else torch.zeros_like(got))
    err = (got - want).abs()
    assert (err <= step + MODEL_GAP * want.abs().max()).all(), \
        (err - step).max().item()


def test_compare_trees_times_phase_9s_cases():
    """``compare_trees.py --int8-mm`` times both trees' int8_matmul at
    phase 9's cases (the parent's phase may lack some) through the one
    runner of the extras; its child program compiles."""
    import importlib.util
    from pathlib import Path

    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)     # importing runs nothing
    assert CT.MM_CASES == smoke.INT8_MM_CASES
    assert CT.EXTRAS["int8_mm"] == (CT.MM_CASES, CT._MM_CHILD)
    compile(f"CASES = {CT.MM_CASES!r}\n" + CT._MM_CHILD, "int8_mm", "exec")
    assert "int8_matmul" in CT.INT8_KERNELS


def test_the_probe_builds_edit_the_product_loop(tmp_path, monkeypatch):
    """``scripts/int8_mm_probe.py``'s text edits each apply once to the
    weight phases' product loop (a probe of a loop that moved fails here,
    not on the card)."""
    from cmw_rag_tpu_torch.scripts import int8_mm_probe as P

    monkeypatch.setattr(P, "PROBE_DIR", tmp_path)
    for name, edits in P.PROBES.items():
        src = P.probe_source(name)
        text = (src.parent / "weight_phases.cuh").read_text()
        assert src.is_file()
        assert all(new in text for _, new in edits if new)
