"""The port's CUDA kernels against their plain twins, on a card.

Every test here needs an NVIDIA card and skips without one. The file imports
torch, numpy and the port only, so that it runs on the card's machine, which
has no jax; there the JAX-importing ``tests/conftest.py`` is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: scan and IVF scan scores to 1e-4 and ids wherever neighbouring scores differ
by more than that (float32 sums in another order); flash attention output,
against the twin run over the kernel's own tiles (so both round p against
the same running maxima), to one bf16 step at its magnitude plus 2e-3 (both
round the output to bf16, so values a hair apart may round one step apart),
its log-sum-exp to 1e-4 (float32 on both sides); paged decode attention
over bf16 pages to one bf16 step at the twin's magnitude plus 1e-5 (float32
sums in another order, then both round to bf16), over int8 pages to one
step plus 2e-2 (the twin, as JAX's golden, rounds the dequantized K and V to
bf16 before attending; the kernel keeps them in float32), with the scatter
wrapper's pools equal to the twin's bit for bit. The int8-weight kernels:
int8_matmul to one bf16 step (bf16 outputs) plus 1e-5 of the largest
|output| (float32 sums of exact products in another order); slot-major
attention as the paged kernel; the fused MLP and the decoder-layer
megakernel to one bf16 step plus 1e-3 of the largest |output| (both round
the normed input, y and h to bf16, and sums in another order can put one of
those a step apart, which moves every product it feeds), the megakernel's
written pool rows within the same of the twin's and every other row
unchanged, bit for bit. The W8A8 matmul and the int8 x int8 scan equal
their twins bit for bit (exact integer sums, the same scale order); the
int8-KV megakernel's output as the megakernel's, its written int8 rows
within one step of the twin's and its updated scales within one bf16 step,
every other row and scale (the null page's excepted) bit for bit; the
batched, stream and DMA aliases equal the kernels they alias. The flash
backward kernels (dQ, dK/dV) against the backward twins, each over its
kernel's own tiles (``bwd_kernel_tiles()``): one bf16 step at the twin's
magnitude plus 1e-3 of the tensor's largest |value| (both round ds to
bf16, and a ds whose float32 value lands a bit apart rounds one step
apart, moving the products it feeds); dK and dV past a batch row's last
real key exactly 0.
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu_torch.index.flat import FlatIndex
from cmw_rag_tpu_torch.index.ivf import IVFIndex
from cmw_rag_tpu_torch.index.shards import SegmentedIndex
from cmw_rag_tpu_torch.ops import decoder_layer as DL
from cmw_rag_tpu_torch.ops import flash_attention as F
from cmw_rag_tpu_torch.ops import fused_mlp as FM
from cmw_rag_tpu_torch.ops import int8_matmul as IM
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.ops import paged_attention as PA
from cmw_rag_tpu_torch.ops import topk as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _unit(n, d, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _same_ranking(got, want):
    (gs, gi), (ws, wi) = got, want
    assert (gs - ws).abs().max().item() <= 1e-4
    gap = (ws[:, 1:] - ws[:, :-1]).abs() > 1e-4
    clear = torch.ones_like(wi, dtype=torch.bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert torch.equal(gi[clear], wi[clear])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 20, 129, 1000, 3000, 5000])
def test_scan_kernels_match_plain_twins(card, int8, k):
    """Any k, up to and past N = 3000 rows (10% tombstones)."""
    c = torch.from_numpy(_unit(3000, 64, 1)).to(card).bfloat16()
    q = torch.from_numpy(_unit(5, 64, 2)).to(card).bfloat16()
    ids = torch.arange(3000, dtype=torch.int32, device=card)
    ids[torch.from_numpy(np.random.default_rng(3).choice(3000, 300, False))
        .to(card)] = -1
    before = (T.topk_scan_bf16.launches, T.topk_scan_int8.launches)
    if int8:
        c8, sc = T.quantize_rows_int8(c)
        got = T.topk_scan_int8(c8, sc, ids, q, k)
        want = T.topk_plain_int8(c8, sc, ids, q, k)
    else:
        got = T.topk_scan_bf16(c, ids, q, k)
        want = T.topk_plain(c, ids, q, k)
    torch.cuda.synchronize()
    assert got[1].shape == (5, k)
    _same_ranking(got, want)
    assert (got[1][:, 2700:] == -1).all()
    after = (T.topk_scan_bf16.launches, T.topk_scan_int8.launches)
    assert after[int(int8)] == before[int(int8)] + 1


def _flash_masks(b, L, card):
    """Key masks of ``b`` = 5 batch rows over three tiles: every key real; a
    length that ends inside the second tile; leading zeros past tile 0 then
    an end inside the third; no real key at all; holes in tile 0 and an end
    inside it, so that the kernel skips the tiles past it."""
    mask = torch.ones((b, L), dtype=torch.int32, device=card)
    mask[1, 200:] = 0
    mask[2, :150] = 0
    mask[2, 300:] = 0
    mask[3] = 0
    mask[4, 5:10] = 0
    mask[4, 100:] = 0
    return mask


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_twin(card, d, causal):
    """L of three 128-row tiles (causal tiles below, on and above the
    diagonal), over the masks of ``_flash_masks``: a row that sees no real
    key takes p = 1 over every processed key in both."""
    g = torch.Generator(device=card).manual_seed(d + causal)
    b, h, L = 5, 3, 384
    q, k, v = (torch.randn((b * h, L, d), generator=g, device=card)
               .bfloat16() for _ in range(3))
    mask = _flash_masks(b, L, card)
    before = F.flash_attention_fwd.launches
    o, lse = F.flash_attention_fwd(q, k, v, mask, h, causal)
    assert (F.kernel_tile(), F.kernel_tiles()) == (F.TILE, F.TILES)
    po, pl = F.flash_attention_plain(q, k, v, mask, h, causal,
                                     *F.kernel_tiles())
    o2 = F.flash_attention(q, k, v, mask, h, causal)
    torch.cuda.synchronize()
    assert F.flash_attention_fwd.launches == before + 1
    assert torch.equal(o, o2)
    err = (o.float() - po.float()).abs()
    x = po.float()
    step = torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8))
    assert (err <= step + 2e-3).all()
    assert (lse - pl).abs().max().item() <= 1e-4


def _bwd_case(card, d, causal, seed, b=5, h=3, L=384):
    """Random bf16 q, k, v, dO over ``_flash_masks`` with the forward
    kernel's o and lse: → (inputs of the backward wrappers, o)."""
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v, do = (torch.randn((b * h, L, d), generator=g, device=card)
                   .bfloat16() for _ in range(4))
    mask = _flash_masks(b, L, card)
    o, lse = F.flash_attention_fwd(q, k, v, mask, h, causal)
    return (q, k, v, mask, do, lse, F.bwd_delta(o, do), h, causal), o


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_match_twin(card, d, causal):
    """L of three 128-row tiles over the masks of ``_flash_masks``: each
    twin at its kernel's own tiles (``bwd_kernel_tiles()``), so that both
    skip the same causal blocks (a row with no real key takes p = 1 over
    the keys of every processed block)."""
    args, _ = _bwd_case(card, d, causal, 10 * d + causal)
    before = (F.flash_attention_bwd_dq.launches,
              F.flash_attention_bwd_dkv.launches)
    dq = F.flash_attention_bwd_dq(*args)
    dk, dv = F.flash_attention_bwd_dkv(*args)
    dq_tiles, dkv_tiles = F.bwd_kernel_tiles()
    assert (dq_tiles, dkv_tiles) == F.BWD_TILES
    want = (F.flash_attention_bwd_dq_plain(*args, *dq_tiles),
            *F.flash_attention_bwd_dkv_plain(*args, *dkv_tiles))
    torch.cuda.synchronize()
    assert (F.flash_attention_bwd_dq.launches,
            F.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        err = (got.float() - ref.float()).abs()
        assert (err <= _bf16_step(ref) + 1e-3 * ref.float().abs().max()).all()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_keys_past_the_last_real_key_get_zero(card, causal):
    """dK and dV are exactly 0 on every key past a batch row's last real
    key, whether its tile is skipped whole or processed (rows 1, 2 and 4
    of ``_flash_masks``)."""
    args, _ = _bwd_case(card, 128, causal, 77 + causal)
    dk, dv = F.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    for row, last in ((1, 199), (2, 299), (4, 99)):
        for g in (dk, dv):
            past = g.view(5, 3, 384, 128)[row, :, last + 1:]
            assert torch.equal(past, torch.zeros_like(past))


def test_flash_trainable_backward_runs_the_kernels(card):
    """``FlashAttentionTrainable`` on CUDA tensors: one forward, one dQ and
    one dK/dV launch, gradients as the twin's."""
    g = torch.Generator(device=card).manual_seed(3)
    b, h, L, d = 2, 2, 128, 64
    q, k, v, do = (torch.randn((b * h, L, d), generator=g, device=card)
                   .bfloat16() for _ in range(4))
    mask = torch.ones((b, L), dtype=torch.int32, device=card)
    mask[0, 90:] = 0
    F.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = F.flash_attention_trainable(*leaves, mask, h, True)
    got = torch.autograd.grad(o, leaves, do)
    assert (F.total_launches(), F.flash_attention_bwd_dq.launches,
            F.flash_attention_bwd_dkv.launches) == (1, 1, 1)
    lse = F.flash_attention_fwd(q, k, v, mask, h, True)[1]
    args = (q, k, v, mask, do, lse, F.bwd_delta(o.detach(), do), h, True)
    (dq_tiles, dkv_tiles) = F.BWD_TILES
    want = (F.flash_attention_bwd_dq_plain(*args, *dq_tiles),
            *F.flash_attention_bwd_dkv_plain(*args, *dkv_tiles))
    for a, ref in zip(got, want):
        err = (a.float() - ref.float()).abs()
        assert (err <= _bf16_step(ref) + 1e-3 * ref.float().abs().max()).all()


def test_flash_backward_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 128, 64), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 128), dtype=torch.int32, device=card)
    lse = torch.zeros((2, 128, 1), dtype=torch.float32, device=card)
    with pytest.raises(TypeError, match="do"):
        F.flash_attention_bwd_dq(q, q, q, mask, q.float(), lse, lse, 2)
    with pytest.raises(ValueError, match="lse"):
        F.flash_attention_bwd_dkv(q, q, q, mask, q, lse[:, :64], lse, 2)


def test_flash_backward_refuses_a_misaligned_do_and_an_l_off_the_tile(card):
    """dO must start on a 16-byte boundary (TMA), and L must be a multiple
    of the largest of the kernels' tiles (128): 192 is one of dK/dV's 64
    but not of dQ's 128."""
    q = torch.zeros((2, 128, 64), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 128), dtype=torch.int32, device=card)
    lse = torch.zeros((2, 128, 1), dtype=torch.float32, device=card)
    flat = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=card)
    do = flat[1:].view(2, 128, 64)   # contiguous, 2 bytes off a boundary
    for fn in (F.flash_attention_bwd_dq, F.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte"):
            fn(q, q, q, mask, do, lse, lse, 2)
    q = torch.zeros((2, 192, 64), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 192), dtype=torch.int32, device=card)
    lse = torch.zeros((2, 192, 1), dtype=torch.float32, device=card)
    for fn in (F.flash_attention_bwd_dq, F.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="multiple"):
            fn(q, q, q, mask, q, lse, lse, 2)


def test_flash_wrappers_refuse_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 100, 64), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 100), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple"):
        F.flash_attention_fwd(q, q, q, mask, 2)
    q = torch.zeros((2, 128, 48), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 128), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        F.flash_attention_fwd(q, q, q, mask, 2)
    flat = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=card)
    q = flat[1:].view(2, 128, 64)   # contiguous, 2 bytes off a boundary
    with pytest.raises(ValueError, match="16-byte"):
        F.flash_attention_fwd(q, q, q, mask, 2)
    with pytest.raises(TypeError):
        F.flash_attention_fwd(q.float(), q.float(), q.float(), mask, 2)


def test_flat_index_on_the_card_matches_the_cpu(card):
    v = _unit(3000, 64, 4)
    got_idx = FlatIndex(dim=64, capacity=4096, device=card)
    want_idx = FlatIndex(dim=64, capacity=4096, device="cpu")
    for idx in (got_idx, want_idx):
        idx.add(v)
        idx.delete(list(range(0, 3000, 7)))
    q = _unit(6, 64, 5)
    for k in (10, 200, 3000):
        gs, gi = got_idx.search(q, k)
        ws, wi = want_idx.search(q, k)
        _same_ranking((torch.from_numpy(gs), torch.from_numpy(gi)),
                      (torch.from_numpy(ws), torch.from_numpy(wi)))


def _ivf_case(card, int8, block_n=192, n_blocks=16, d=64):
    """A blocked corpus with 10% tombstones, a duplicated row (an exact tie
    across two blocks) and queries."""
    n = n_blocks * block_n
    c = torch.from_numpy(_unit(n, d, 6)).to(card).bfloat16()
    c[5 * block_n + 7] = c[2 * block_n + 3]
    ids = torch.randperm(n, generator=torch.Generator().manual_seed(7)).to(
        card, torch.int32)
    ids[torch.from_numpy(np.random.default_rng(8).choice(n, n // 10, False))
        .to(card)] = -1
    q = torch.from_numpy(_unit(6, d, 9)).to(card).bfloat16()
    q[0] = c[2 * block_n + 3]
    scales = None
    if int8:
        c, scales = T.quantize_rows_int8(c)
    return c, scales, ids, q


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("k", [1, 20, 129, 1000, 5000])
def test_ivf_kernels_match_plain_twins(card, int8, union, k):
    """Blocks of 192 rows (a ragged last tile), repeated blocks in a list,
    padding past n_unique, any k up to past the rows scanned."""
    block_n = 192
    c, sc, ids, q = _ivf_case(card, int8, block_n)
    if union:
        table = torch.tensor([1, 2, 5, 9, 12, 2, 15, 0, 0, 0], dtype=torch.int32,
                             device=card)
        nu = torch.tensor([7], dtype=torch.int32, device=card)
        args = (table, k, block_n, nu)
        fn = V.ivf_union_scan_int8 if int8 else V.ivf_union_scan
        twin = lambda *a: V.ivf_union_plain(*a, scales=sc)  # noqa: E731
    else:
        table = torch.tensor([[2, 5, 5, 7], [0, 1, 2, 3], [15, 14, 13, 12],
                              [3, 9, 11, 2], [8, 8, 8, 8], [6, 4, 2, 0]],
                             dtype=torch.int32, device=card)
        args = (table, k, block_n)
        fn = V.ivf_probed_scan_int8 if int8 else V.ivf_probed_scan
        twin = lambda *a: V.ivf_probed_plain(*a, scales=sc)  # noqa: E731
    before = fn.launches
    got = fn(c, sc, ids, q, *args) if int8 else fn(c, ids, q, *args)
    want = twin(c, ids, q, *args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got[1].shape == (6, k)
    _same_ranking(got, want)
    for row in got[1].tolist():
        live = [i for i in row if i >= 0]
        assert len(live) == len(set(live))        # a repeated block adds nothing
    empty = got[1] < 0
    assert torch.equal(empty, want[1] < 0)
    assert (got[0][empty] == T.NEG_INF).all()


def test_ivf_wrappers_refuse_what_the_kernel_does_not_take(card):
    c, _, ids, q = _ivf_case(card, False, block_n=128)
    table = torch.zeros((6, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of block_n"):
        V.ivf_probed_scan(c, ids, q, table, 5, block_n=100)
    with pytest.raises(TypeError):
        V.ivf_probed_scan(c.float(), ids, q, table, 5, block_n=128)
    with pytest.raises(ValueError, match="shape"):
        V.ivf_probed_scan(c, ids, q, table[:3], 5, block_n=128)
    with pytest.raises(ValueError):
        V.ivf_probed_scan(c, ids, q.cpu(), table, 5, block_n=128)


@pytest.mark.parametrize("quantize", [False, True])
def test_ivf_and_segmented_indexes_on_the_card_match_the_cpu(card, quantize):
    """An index built on the CPU and carried to the card answers as on the
    CPU, for one query (probed) and a batch (union); a segmented index on
    the card finds its sealed, pending-free and tail rows."""
    v = _unit(4096, 64, 10)
    cpu = IVFIndex.build(v, block_n=256, device="cpu", quantize=quantize)
    gpu = IVFIndex(cpu.corpus, cpu.ids, cpu.block_centroids, 256,
                   scales=cpu.scales, device=card)
    q = _unit(6, 64, 11)
    for qq in (q[:1], q):
        gs, gi = gpu.search(qq, 20, nprobe=4)
        ws, wi = cpu.search(qq, 20, nprobe=4)
        _same_ranking((torch.from_numpy(gs), torch.from_numpy(gi)),
                      (torch.from_numpy(ws), torch.from_numpy(wi)))
    seg = SegmentedIndex(dim=64, block_n=256, seal_threshold=1024,
                         quantize=quantize, device=card)
    for a in range(0, 2500, 500):     # seals at 1500 and at 2500 rows
        seg.add(v[a : a + 500], np.arange(a, a + 500, dtype=np.int32))
    assert len(seg.sealed) == 2 and seg.n_live == 2500
    assert seg.delete([3, 2400]) == 2
    s, i = seg.search(v[[10, 1500, 2450, 3]], 5)
    assert i[:3, 0].tolist() == [10, 1500, 2450] and (s[:3, 0] > 0.99).all()
    assert 3 not in i[3]


def _bf16_step(x):
    x = x.float()
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
    return torch.where(x == 0, torch.zeros_like(x), step)


def _paged_case(card, s, hq, hkv, dh, page, maxp, lens, seed, layers=2):
    """Pools of ``layers`` layers with distinct pages per slot, ragged
    ``lens`` and, as the last slot, one idle slot (table all page 0,
    length 1). → q, k_pools, v_pools, tables, lens (int32, on the card)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + s * maxp
    shape = (layers, n_pages, page, hkv, dh)
    kp = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(card)
    vp = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(card)
    q = torch.from_numpy(rng.standard_normal((s, hq, dh), np.float32)).to(card)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(s, maxp)
    lens = np.asarray(list(lens) + [1], np.int32)
    tables[-1] = 0
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
            torch.from_numpy(tables.astype(np.int32)).to(card),
            torch.from_numpy(lens).to(card))


PAGED_SHAPES = [  # S, Hq, Hkv, Dh, page, maxp, lens of the active slots
    (4, 16, 8, 128, 64, 32, [1, 63, 2047]),          # serving: 4 slots x 2048
    (8, 16, 8, 128, 64, 16, [64, 65, 257, 300, 1, 1000, 1024]),
    (32, 16, 8, 128, 64, 16, [1 + 33 * i for i in range(31)]),
    (3, 4, 4, 64, 16, 6, [5, 96]),                   # no GQA, Dh 64, page 16
    (5, 32, 4, 128, 32, 8, [17, 32, 33, 200]),       # 8 query heads a KV head
]


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("kind", ["dma", "scatter", "int8"])
def test_paged_attention_kernels_match_plain_twins(card, shape, kind):
    s, hq, hkv, dh, page, maxp, lens = shape
    q, kp, vp, tables, lens = _paged_case(card, s, hq, hkv, dh, page, maxp,
                                          lens, seed=s + dh)
    layer, act = 1, slice(0, s - 1)
    if kind == "int8":
        kq, ks = PA.quantize_kv_page(kp)
        vq, vs = PA.quantize_kv_page(vp)
        n0 = PA.paged_decode_attention_dma_kv_int8.launches
        got = PA.paged_decode_attention_dma_kv_int8(q, kq, ks, vq, vs, tables,
                                                    lens, layer=layer)
        want = PA.paged_decode_attention_dma_kv_int8(
            q.cpu(), kq.cpu(), ks.cpu(), vq.cpu(), vs.cpu(), tables.cpu(),
            lens.cpu(), layer=layer).to(card)
        assert PA.paged_decode_attention_dma_kv_int8.launches == n0 + 1
        tol = 2e-2
    elif kind == "scatter":
        rng = np.random.default_rng(s)
        k_new = torch.from_numpy(rng.standard_normal(
            (s, hkv, dh), np.float32)).to(card).bfloat16()
        v_new = torch.from_numpy(rng.standard_normal(
            (s, hkv, dh), np.float32)).to(card).bfloat16()
        pos = (lens - 1).long()
        page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
        page_idx, off = page_idx.to(torch.int32), (pos % page).to(torch.int32)
        k_cpu, v_cpu = kp.cpu(), vp.cpu()
        n0 = PA.paged_decode_attention_dma_scatter.launches
        got, k_out, v_out = PA.paged_decode_attention_dma_scatter(
            q, k_new, v_new, page_idx, off, kp, vp, tables, lens, layer=layer)
        want, k_want, v_want = PA.paged_decode_attention_dma_scatter(
            q.cpu(), k_new.cpu(), v_new.cpu(), page_idx.cpu(), off.cpu(),
            k_cpu, v_cpu, tables.cpu(), lens.cpu(), layer=layer)
        assert PA.paged_decode_attention_dma_scatter.launches == n0 + 1
        assert k_out is kp and v_out is vp      # updated in place
        torch.cuda.synchronize()
        assert torch.equal(kp.cpu(), k_want) and torch.equal(vp.cpu(), v_want)
        want = want.to(card)
        tol = 1e-5
    else:
        n0 = PA.paged_decode_attention_dma.launches
        got = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=layer)
        want = PA.paged_decode_attention_dma(q.cpu(), kp.cpu(), vp.cpu(),
                                             tables.cpu(), lens.cpu(),
                                             layer=layer).to(card)
        assert PA.paged_decode_attention_dma.launches == n0 + 1
        tol = 1e-5
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got[act].float() - want[act].float()).abs()
    assert (err <= _bf16_step(want[act]) + tol).all(), err.max().item()


def test_paged_attention_aliases_launch_the_kernel(card):
    q, kp, vp, tables, lens = _paged_case(card, 4, 16, 8, 128, 64, 8,
                                          [1, 64, 500], seed=3)
    want = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=0)
    n0 = (PA.paged_decode_attention.launches,
          PA.paged_decode_attention_pooled.launches)
    one = PA.paged_decode_attention(q, kp[0].contiguous(), vp[0].contiguous(),
                                    tables, lens)
    pooled = PA.paged_decode_attention_pooled(q, kp, vp, tables, lens, layer=0)
    torch.cuda.synchronize()
    assert torch.equal(one, want) and torch.equal(pooled, want)
    assert (PA.paged_decode_attention.launches,
            PA.paged_decode_attention_pooled.launches) == (n0[0] + 1, n0[1] + 1)


def test_paged_attention_kernel_never_reads_past_the_length(card):
    """NaN in every row at or past a slot's length (a preempted request's
    leftovers) leaves the output as it was: those rows are skipped, not
    weighted 0 (NaN * 0 is NaN)."""
    q, kp, vp, tables, lens = _paged_case(card, 4, 16, 8, 128, 64, 8,
                                          [1, 64, 500], seed=5)
    want = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=0)
    for s, n in enumerate(lens.tolist()):
        for j in range(tables.shape[1]):
            page = int(tables[s, j])
            start = min(max(n - j * 64, 0), 64)
            if page and start < 64:
                kp[0, page, start:] = float("nan")
                vp[0, page, start:] = float("nan")
    got = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=0)
    torch.cuda.synchronize()
    assert torch.equal(got[:3], want[:3])


def test_paged_attention_wrappers_refuse_what_the_kernel_does_not_take(card):
    q, kp, vp, tables, lens = _paged_case(card, 2, 16, 8, 128, 16, 4, [9],
                                          seed=1)
    with pytest.raises(TypeError):
        PA.paged_decode_attention_dma(q.float(), kp, vp, tables, lens, layer=0)
    with pytest.raises(TypeError):
        PA.paged_decode_attention_dma(q, kp, vp, tables.long(), lens, layer=0)
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_decode_attention_dma(q.transpose(0, 1).contiguous()
                                      .transpose(0, 1), kp, vp, tables, lens,
                                      layer=0)
    with pytest.raises(ValueError, match="layer"):
        PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=2)
    with pytest.raises(ValueError, match="ratio"):
        PA.paged_decode_attention_dma(q[:, :12].contiguous(), kp, vp, tables,
                                      lens, layer=0)
    with pytest.raises(ValueError, match="head dim"):
        PA.paged_decode_attention_dma(q[..., :96].contiguous(),
                                      kp[..., :96].contiguous(),
                                      vp[..., :96].contiguous(), tables, lens,
                                      layer=0)
    with pytest.raises(ValueError):
        PA.paged_decode_attention_dma(q, kp, vp, tables.cpu(), lens, layer=0)
    # the batched schedules take the kernel's checks (nothing is deferred)
    with pytest.raises(TypeError):
        PA.paged_decode_attention_dma_batched(q.float(), kp, vp, tables, lens,
                                              layer=0)
    with pytest.raises(TypeError):
        PA.paged_decode_attention_dma_scatter(
            q, kp[0, 0, :2].float(), vp[0, 0, :2].float(), lens, lens, kp, vp,
            tables, lens, layer=0, batched=True)


def _close(got, want, tol):
    """Within one bf16 step (bf16 outputs; at the larger magnitude of the
    two, so a rounding across a power of two counts one step) plus ``tol``
    of the largest |want|."""
    err = (got.float() - want.float()).abs()
    step = (_bf16_step(torch.maximum(got.float().abs(), want.float().abs()))
            if want.dtype == torch.bfloat16 else torch.zeros_like(err))
    assert (err <= step + tol * want.float().abs().max()).all(), \
        err.max().item()


def _q8(card, gen, k, n):
    return IM.quantize_weight(torch.randn((k, n), generator=gen,
                                          device=card) * 0.05)


@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (4, 1024, 4096),
                                   (5, 256, 1040), (16, 1024, 4096),
                                   (33, 128, 512), (4, 1024, 151680)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_matches_plain_twin(card, m, k, n, dtype):
    gen = torch.Generator(device=card).manual_seed(m + n)
    wq, ws = _q8(card, gen, k, n)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    n0 = IM.int8_matmul.launches
    got = IM.int8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert IM.int8_matmul.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, IM.int8_matmul_plain(x, wq, ws), 1e-5)
    assert torch.equal(got, IM.int8_matmul(x, wq, ws))   # repeats exactly


def _slot_case(card, s, hq, hkv, dh, page, maxp, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (2, 1 + s * maxp, page, hkv, dh)
    kp = torch.randn(shape, generator=gen, device=card).bfloat16()
    vp = torch.randn(shape, generator=gen, device=card).bfloat16()
    q = torch.randn((s, hq, dh), generator=gen, device=card).bfloat16()
    return q, kp, vp


@pytest.mark.parametrize("shape", [
    (4, 16, 8, 128, 64, 32, 6, [1, 64, 200, 384]),
    (16, 16, 8, 128, 64, 32, 2, [1 + 8 * i for i in range(16)]),
    (3, 4, 4, 64, 16, 6, 6, [5, 96, 90]),
    (2, 32, 4, 128, 64, 20, 20, [1280, 700])])   # past one 1,024 chunk
def test_slot_attention_matches_plain_twin(card, shape):
    s, hq, hkv, dh, page, maxp, cap, lens = shape
    q, kp, vp = _slot_case(card, s, hq, hkv, dh, page, maxp, seed=s + cap)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    n0 = PA.paged_decode_attention_dma_slot.launches
    got = PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=1,
                                             cap=cap, maxp_slot=maxp)
    want = PA.paged_decode_attention_slot_plain(q, kp[1], vp[1], lens, cap,
                                                maxp)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention_dma_slot.launches == n0 + 1
    err = (got.float() - want.float()).abs()
    assert (err <= _bf16_step(want) + 1e-5).all(), err.max().item()


def test_slot_attention_never_reads_past_the_length_or_cap(card):
    """NaN in every row at or past a slot's length, and in its partition's
    pages past the cap, leaves the output as it was."""
    s, page, maxp, cap = 3, 64, 8, 4
    q, kp, vp = _slot_case(card, s, 16, 8, 128, page, maxp, seed=11)
    lens = torch.tensor([1, 100, 256], dtype=torch.int32, device=card)
    want = PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=0,
                                              cap=cap, maxp_slot=maxp)
    for si, n in enumerate(lens.tolist()):
        for j in range(maxp):
            start = min(max(n - j * page, 0), page)
            kp[0, 1 + si * maxp + j, start:] = float("nan")
            vp[0, 1 + si * maxp + j, start:] = float("nan")
    got = PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=0,
                                             cap=cap, maxp_slot=maxp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _layer(card, gen, d, hq, hkv, dh, f):
    lay = {k: 1.0 + 0.1 * torch.randn((n,), generator=gen, device=card)
           for k, n in (("attn_norm", d), ("ffn_norm", d), ("q_norm", dh),
                        ("k_norm", dh))}
    lay["wqkv_q"], lay["wqkv_s"] = _q8(card, gen, d, (hq + 2 * hkv) * dh)
    lay["wo_q"], lay["wo_s"] = _q8(card, gen, hq * dh, d)
    lay["w_gateup_q"], lay["w_gateup_s"] = _q8(card, gen, d, 2 * f)
    lay["w_down_q"], lay["w_down_s"] = _q8(card, gen, f, d)
    return lay


MLP = ("wo_q", "wo_s", "ffn_norm", "w_gateup_q", "w_gateup_s", "w_down_q",
       "w_down_s")
LAYER = ("attn_norm", "wqkv_q", "wqkv_s", "q_norm", "k_norm") + MLP


@pytest.mark.parametrize("s,d,a,f", [(4, 1024, 2048, 3072),
                                     (16, 1024, 2048, 3072),
                                     (1, 256, 512, 384), (40, 256, 128, 192)])
def test_fused_mlp_matches_plain_twin(card, s, d, a, f):
    gen = torch.Generator(device=card).manual_seed(s + d)
    lay = _layer(card, gen, d, a // 128, a // 128, 128, f)
    x = torch.randn((s, d), generator=gen, device=card).bfloat16()
    attn = (0.1 * torch.randn((s, a), generator=gen, device=card)).bfloat16()
    n0 = FM.fused_mlp_int8.launches
    got = FM.fused_mlp_int8(x, attn, *[lay[k] for k in MLP])
    want = FM.fused_mlp_int8_plain(x, attn, *[lay[k] for k in MLP])
    torch.cuda.synchronize()
    assert FM.fused_mlp_int8.launches == n0 + 1 and got.dtype == torch.bfloat16
    _close(got, want, 1e-3)
    assert torch.equal(got, FM.fused_mlp_int8(x, attn, *[lay[k] for k in MLP]))


@pytest.mark.parametrize("case", [
    # S, Hq, Hkv, Dh, D, F, page, maxp, lens, slot-major
    (4, 16, 8, 128, 1024, 3072, 64, 32, [63, 200, 384], True),
    (4, 16, 8, 128, 1024, 3072, 64, 32, [1, 700, 2047], False),
    (9, 8, 2, 64, 256, 384, 16, 4, [1, 16, 17, 30, 33, 48, 63, 64], False),
    (3, 8, 2, 64, 256, 384, 16, 4, [5, 40], True)])
def test_decoder_layer_matches_plain_twin(card, case):
    s, hq, hkv, dh, d, f, page, maxp, lens, slot = case
    gen = torch.Generator(device=card).manual_seed(s + d)
    lay = _layer(card, gen, d, hq, hkv, dh, f)
    n_pages = 1 + s * maxp
    shape = (2, n_pages, page, hkv, dh)
    kp = torch.randn(shape, generator=gen, device=card).bfloat16()
    vp = torch.randn(shape, generator=gen, device=card).bfloat16()
    lens_t = torch.tensor(lens + [1], dtype=torch.int32, device=card)
    if slot:
        tables = PA.slot_tables(s, maxp, maxp, 1, card)
        kw = dict(attn_slot=True, slot_cap=-(-max(lens) // page),
                  slot_maxp=maxp)
    else:
        tables = (torch.randperm(n_pages - 1, generator=gen, device=card)
                  + 1).reshape(s, maxp).to(torch.int32)
        tables[-1] = 0
        kw = dict(tables=tables)
    pos = (lens_t - 1).long()
    page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    page_idx[-1] = 0
    off = (pos % page).to(torch.int32)
    off[-1] = 0
    page_idx = page_idx.to(torch.int32)
    x = torch.randn((s, d), generator=gen, device=card).bfloat16()
    ang = torch.rand((s, dh // 2), generator=gen, device=card) * 6.28
    c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
    args = (x, c2, s2, *[lay[k] for k in LAYER], page_idx, off)
    k_tw, v_tw = kp.clone(), vp.clone()
    n0 = DL.decoder_layer_int8.launches
    got, k_out, v_out = DL.decoder_layer_int8(*args, kp, vp, lens_t, layer=1,
                                              **kw)
    want, _, _ = DL.decoder_layer_int8_plain(*args, k_tw, v_tw, lens_t,
                                             layer=1, **kw)
    torch.cuda.synchronize()
    assert DL.decoder_layer_int8.launches == n0 + 1
    assert k_out is kp and v_out is vp
    _close(got[:s - 1], want[:s - 1], 1e-3)
    rows = (page_idx.long(), off.long())
    for pool, twin in ((kp, k_tw), (vp, v_tw)):
        keep = torch.ones(pool.shape[:3], dtype=torch.bool, device=card)
        keep[1][rows] = False
        assert torch.equal(pool[keep], twin[keep])
        _close(pool[1][rows], twin[1][rows], 1e-3)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(card):
    gen = torch.Generator(device=card).manual_seed(0)
    wq, ws = _q8(card, gen, 64, 128)
    x = torch.randn((2, 64), device=card)
    with pytest.raises(TypeError):
        IM.int8_matmul(x.half(), wq, ws)
    with pytest.raises(ValueError, match="multiple"):
        IM.int8_matmul(x[:, :48].contiguous(), wq[:48].contiguous(), ws)
    with pytest.raises(ValueError):
        IM.int8_matmul(x, wq.cpu(), ws)
    q, kp, vp = _slot_case(card, 2, 16, 8, 128, 64, 4, seed=1)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="overrun"):
        PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=0, cap=5,
                                           maxp_slot=4)
    with pytest.raises(ValueError, match="ratio"):
        PA.paged_decode_attention_dma_slot(
            torch.randn((2, 72, 128), device=card).bfloat16(), kp, vp, lens,
            layer=0, cap=1, maxp_slot=4)


@pytest.mark.parametrize("m,k,n", [(4, 1024, 4096), (16, 1024, 4096),
                                   (4, 2048, 1024), (4, 1024, 6144),
                                   (16, 3072, 1024), (4, 1024, 151680),
                                   (1, 64, 16), (5, 256, 1040),
                                   (33, 128, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_matmul_equals_plain_twin(card, m, k, n, dtype):
    gen = torch.Generator(device=card).manual_seed(m * 7 + n)
    wq, ws = _q8(card, gen, k, n)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    n0 = IM.int8_matmul_w8a8.launches
    got = IM.int8_matmul_w8a8(x, wq, ws)
    torch.cuda.synchronize()
    assert IM.int8_matmul_w8a8.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, IM.int8_matmul_w8a8_plain(x, wq, ws))


def _kv8_case(card, s, hq, hkv, dh, d, f, page, maxp, lens, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    lay = _layer(card, gen, d, hq, hkv, dh, f)
    n_pages = 1 + s * maxp
    shape = (2, n_pages, page, hkv, dh)
    kq, ks = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                             device=card))
    vq, vs = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                             device=card))
    lens_t = torch.tensor(lens + [1], dtype=torch.int32, device=card)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=card)
              + 1).reshape(s, maxp).to(torch.int32)
    tables[-1] = 0                                    # the idle slot
    pos = (lens_t - 1).long()
    page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    page_idx[-1] = 0
    off = (pos % page).to(torch.int32)
    off[-1] = 0
    x = torch.randn((s, d), generator=gen, device=card).bfloat16()
    ang = torch.rand((s, dh // 2), generator=gen, device=card) * 6.28
    c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
    args = (x, c2, s2, *[lay[k] for k in LAYER], page_idx.to(torch.int32),
            off)
    return args, (kq, ks, vq, vs), lens_t, tables


@pytest.mark.parametrize("case", [
    # S, Hq, Hkv, Dh, D, F, page, maxp, lens (fresh pages among them)
    (4, 16, 8, 128, 1024, 3072, 64, 32, [65, 200, 384]),
    (4, 16, 8, 128, 1024, 3072, 64, 32, [2047, 129, 64]),
    (9, 8, 2, 64, 256, 384, 16, 4, [1, 16, 17, 30, 33, 48, 63, 64])])
def test_decoder_layer_kv8_matches_plain_twin(card, case):
    s, hq, hkv, dh, d, f, page, maxp, lens = case
    args, (kq, ks, vq, vs), lens_t, tables = _kv8_case(
        card, s, hq, hkv, dh, d, f, page, maxp, lens, seed=s + len(lens))
    before = [t.clone() for t in (kq, ks, vq, vs)]
    twin = [t.clone() for t in (kq, ks, vq, vs)]
    n0 = DL.decoder_layer_int8_kv8.launches
    got = DL.decoder_layer_int8_kv8(*args, kq, ks[1], vq, vs[1], lens_t,
                                    layer=1, tables=tables)
    want = DL.decoder_layer_int8_kv8_plain(
        *args, twin[0], twin[1][1], twin[2], twin[3][1], lens_t, layer=1,
        tables=tables)
    torch.cuda.synchronize()
    assert DL.decoder_layer_int8_kv8.launches == n0 + 1
    assert got[1] is kq and got[3] is vq
    assert got[2].data_ptr() == ks[1].data_ptr()
    _close(got[0][:s - 1], want[0][:s - 1], 1e-3)
    page_idx, off = args[-2].long(), args[-1].long()
    act = slice(0, s - 1)
    rows = (page_idx[act], off[act])
    for pool, tw, old in ((kq, twin[0], before[0]), (vq, twin[2], before[2])):
        keep = torch.ones(pool.shape[:3], dtype=torch.bool, device=card)
        keep[1][rows] = False
        keep[1][0] = False                             # the null page
        assert torch.equal(pool[keep], old[keep])
        assert (pool[1][rows].int() - tw[1][rows].int()).abs().max() <= 1
    for plane, tw, old in ((ks, twin[1], before[1]), (vs, twin[3], before[3])):
        keep = torch.ones(plane.shape[:2], dtype=torch.bool, device=card)
        keep[1][page_idx[act]] = False
        keep[1][0] = False
        assert torch.equal(plane[keep], old[keep])
        p = page_idx[act]
        assert ((plane[1][p] - tw[1][p]).abs()
                <= _bf16_step(tw[1][p])).all()


@pytest.mark.parametrize("kv8", [False, True])
def test_megakernel_noattn_matches_plain_twin(card, kv8):
    """The ablation: the attention output is q, in kernel and twin."""
    args, (kq, ks, vq, vs), lens_t, tables = _kv8_case(
        card, 4, 16, 8, 128, 1024, 3072, 64, 8, [65, 200, 384], seed=5)
    if kv8:
        got = DL.decoder_layer_int8_kv8(*args, kq.clone(), ks[1].clone(),
                                        vq.clone(), vs[1].clone(), lens_t,
                                        layer=1, tables=tables,
                                        ablate="noattn")[0]
        want = DL.decoder_layer_int8_kv8_plain(
            *args, kq.clone(), ks[1].clone(), vq.clone(), vs[1].clone(),
            lens_t, layer=1, tables=tables, ablate="noattn")[0]
    else:
        kp = (kq.float() * ks[:, :, None, :, None]).bfloat16()
        vp = (vq.float() * vs[:, :, None, :, None]).bfloat16()
        got = DL.decoder_layer_int8(*args, kp.clone(), vp.clone(), lens_t,
                                    layer=1, tables=tables,
                                    ablate="noattn")[0]
        want = DL.decoder_layer_int8_plain(*args, kp.clone(), vp.clone(),
                                           lens_t, layer=1, tables=tables,
                                           ablate="noattn")[0]
    torch.cuda.synchronize()
    _close(got[:3], want[:3], 1e-3)


def test_batched_stream_and_dma_aliases_equal_their_kernels(card):
    q, kp, vp, tables, lens = _paged_case(card, 4, 16, 8, 128, 64, 32,
                                          [1, 63, 2047], seed=7)
    n0 = PA.paged_decode_attention_dma_batched.launches
    got = PA.paged_decode_attention_dma_batched(q, kp, vp, tables, lens,
                                                layer=1)
    want = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=1)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention_dma_batched.launches == n0 + 1
    assert torch.equal(got, want)
    gen = torch.Generator(device=card).manual_seed(8)
    kn = torch.randn((4, 8, 128), generator=gen, device=card).bfloat16()
    pos = (lens - 1).long()                  # each slot's row lens - 1
    pi = tables.long().gather(1, (pos // 64)[:, None])[:, 0].to(torch.int32)
    off = (pos % 64).to(torch.int32)
    outs = [PA.paged_decode_attention_dma_scatter(
        q, kn, kn, pi, off, kp.clone(), vp.clone(), tables, lens, layer=0,
        batched=b)[0] for b in (False, True)]
    assert torch.equal(outs[0], outs[1])
    c = torch.from_numpy(_unit(3000, 64, 4)).to(card).bfloat16()
    qs = torch.from_numpy(_unit(5, 64, 5)).to(card).bfloat16()
    ids = torch.arange(3000, dtype=torch.int32, device=card)
    ids[::37] = -1
    n0 = T.topk_scan_stream.launches
    got = T.topk_scan_stream(c, ids, qs, 20)
    want = T.topk_scan_bf16(c, ids, qs, 20)
    torch.cuda.synchronize()
    assert T.topk_scan_stream.launches == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    corpus, _, vids, vq = _ivf_case(card, False)
    table = torch.tensor([[0, 3, 5], [2, 2, 9], [15, 1, 4]],
                         dtype=torch.int32, device=card)
    n0 = V.ivf_probed_scan_dma.launches
    got = V.ivf_probed_scan_dma(corpus, vids, vq[:3].contiguous(), table, 20,
                                192)
    want = V.ivf_probed_scan(corpus, vids, vq[:3].contiguous(), table, 20,
                             192)
    torch.cuda.synchronize()
    assert V.ivf_probed_scan_dma.launches == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 20, 129, 1000])
def test_int8mxu_scan_equals_plain_twin(card, k):
    c8, sc = T.quantize_rows_int8(torch.from_numpy(_unit(3000, 128, 6))
                                  .to(card))
    q = torch.from_numpy(_unit(9, 128, 7)).to(card)
    ids = torch.arange(3000, dtype=torch.int32, device=card)
    ids[::29] = -1
    n0 = T.topk_scan_int8mxu.launches
    got = T.topk_scan_int8mxu(c8, sc, ids, q, k)
    want = T.topk_plain_int8mxu(c8, sc, ids, q, k)
    torch.cuda.synchronize()
    assert T.topk_scan_int8mxu.launches == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
