"""The port's CUDA kernels against their plain twins, on a card.

Every test here needs an NVIDIA card and skips without one. The file imports
torch, numpy and the port only, so that it runs on the card's machine, which
has no jax; there the JAX-importing ``tests/conftest.py`` is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: scan and IVF scan scores to 1e-4 and ids wherever neighbouring scores differ
by more than that (float32 sums in another order; the IVF kernels also
at D 5120, at exact ties across CTAs, bit for bit on a second launch and
on two streams at once); flash attention output,
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
attention as the paged kernel; the fused MLP (one kernel a call) and the
decoder-layer megakernel to one bf16 step plus 1e-3 of the largest
|output| (both round the normed input, y and h to bf16, and sums in
another order can put one of those a step apart, which moves every
product it feeds; the megakernel is held against the card reference of
``tests/tensor_core_model.py``, the twin with its QKV product on a model
of the tensor cores' truncating accumulation and its attention in the
kernel's split order, itself held against the plain IEEE twin within one
bf16 step of the attention output carried through wo and the MLP), the
megakernel's
written pool rows within the same of the twin's and every other row
unchanged, bit for bit. The W8A8 matmul and the int8 x int8 scan equal
their twins bit for bit (exact integer sums, the same scale order; the
W8A8 kernel at every split of the contraction, past 16,384 contraction
rows, on rows at the quantization's edges, one kernel a call, two streams
at once); the
int8-KV megakernel's output as the megakernel's, its written int8 rows
within one step of the twin's and its updated scales within one bf16 step,
every other row and scale (the null page's excepted) bit for bit; the
batched, stream and DMA aliases equal the kernels they alias. The flash
backward kernels (dQ, dK/dV) against the backward twins, each over its
kernel's own tiles (``bwd_kernel_tiles()``): one bf16 step at the twin's
magnitude plus 1e-3 of the tensor's largest |value| (both round ds to
bf16, and a ds whose float32 value lands a bit apart rounds one step
apart, moving the products it feeds); dK and dV past a batch row's last
real key exactly 0. Split decode attention (the slot-major kernel and
both megakernels, at splits of 64 and 128 positions): the same tolerances
at lengths on either side of every split boundary, an idle slot, two
launches bit for bit alike (the splits merge in a fixed order, with no
float atomics), and NaN in every row past a slot's length leaving the
output bit for bit as it was. The paged kernel likewise at the host's
split and at splits of 32 and 256 (pages of 16, 64 and 256; rep 1 to 8;
Dh 64 and 128; bf16, the fused write and int8), exactly one kernel a
wrapper call under torch.profiler, and two streams launching at once
each with a workspace of its own.
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
import tensor_core_model as TC

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
@pytest.mark.parametrize("k", [1, 20, 128, 129, 256, 1000, 5000])
def test_ivf_kernels_match_plain_twins(card, int8, union, k):
    """Blocks of 192 rows (a ragged last tile), repeated blocks in a list,
    padding past n_unique, any k up to past the rows scanned; a second
    launch bit for bit the first."""
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
    again = fn(c, sc, ids, q, *args) if int8 else fn(c, ids, q, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _ivf_call(int8, union):
    fn = getattr(V, f"ivf_{'union' if union else 'probed'}_scan"
                 + ("_int8" if int8 else ""))
    return lambda c, sc, ids, q, *a: (fn(c, sc, ids, q, *a) if int8
                                      else fn(c, ids, q, *a))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq", [1, 8, 32])
def test_ivf_kernels_at_d5120(card, int8, nq):
    """D 5120 (the segmented store's): 8 queries keep the query block in
    shared memory, 32 stream it through the ring beside the rows; probed
    and union, k 20 and 300, bit for bit on a second launch."""
    c, sc, ids, q = _ivf_case(card, int8, block_n=256, n_blocks=12, d=5120)
    q = torch.from_numpy(_unit(nq, 5120, 12)).to(card).bfloat16()
    union = nq > 1
    call = _ivf_call(int8, union)
    if union:
        table = torch.tensor([3, 0, 7, 11, 5, 0, 0], dtype=torch.int32,
                             device=card)
        nu = torch.tensor([5], dtype=torch.int32, device=card)
    else:
        table = torch.tensor([[3, 0, 7, 11]], dtype=torch.int32, device=card)
    for k in (20, 300):
        args = (table, k, 256, nu) if union else (table, k, 256)
        got = call(c, sc, ids, q, *args)
        again = call(c, sc, ids, q, *args)
        want = (V.ivf_union_plain(c, ids, q, *args, scales=sc) if union
                else V.ivf_probed_plain(c, ids, q, *args, scales=sc))
        torch.cuda.synchronize()
        _same_ranking(got, want)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [7, 129, 700])
def test_ivf_union_ties_at_the_kth_score_across_ctas(card, int8, k):
    """Every row of 16 blocks is the same vector, so all scores tie
    exactly and the ids decide: the rows of the tie lie in the tiles of
    many scan CTAs and in every selection CTA's slice. The kernel keeps
    the k smallest live ids, in ascending order."""
    c, sc, ids, q = _ivf_case(card, int8, block_n=256, n_blocks=16)
    c[:] = c[0]
    if int8:
        sc[:] = sc[0]
    table = torch.arange(16, dtype=torch.int32, device=card)
    nu = torch.tensor([16], dtype=torch.int32, device=card)
    got = _ivf_call(int8, True)(c, sc, ids, q, table, k, 256, nu)
    want = V.ivf_union_plain(c, ids, q, table, k, 256, nu, scales=sc)
    torch.cuda.synchronize()
    live = torch.sort(ids[ids >= 0]).values[:k]
    assert torch.equal(got[1], live[None, :].expand(q.shape[0], -1))
    assert torch.equal(got[1], want[1])
    assert (got[0] == got[0][:, :1]).all()


def test_ivf_kernels_on_two_streams_at_once(card):
    """Two streams launching union and probed scans at once, each with a
    selection workspace of its own, give what the default stream gives."""
    c, _, ids, q = _ivf_case(card, False, block_n=192)
    table = torch.tensor([1, 2, 5, 9, 12, 2, 15, 0], dtype=torch.int32,
                         device=card)
    nu = torch.tensor([7], dtype=torch.int32, device=card)
    probes = torch.tensor([[2, 5, 5, 7]] * 6, dtype=torch.int32, device=card)
    want = [V.ivf_union_scan(c, ids, q, table, 300, 192, nu),
            V.ivf_probed_scan(c, ids, q, probes, 20, 192)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    got = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                got.append((V.ivf_union_scan(c, ids, q, table, 300, 192, nu),
                            V.ivf_probed_scan(c, ids, q, probes, 20, 192)))
    torch.cuda.synchronize()
    for pair in got:
        for g, w in zip(pair, want):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("union", [False, True])
def test_ivf_kernels_over_query_chunks(card, int8, union):
    """200 queries, nprobe 16 over 40 blocks: the kernel takes the batch in
    chunks of 64 (the last of 8) through one workspace; the union table
    (``union_blocks``) is padded to 3,200 entries, of which the workspace
    holds 40 a query. Each query's ranking is its twin's, bit for bit on a
    second launch, and the workspace stays one chunk's."""
    from cmw_rag_tpu_torch.index.ivf import union_blocks

    nq, nprobe, block_n, n_blocks = 200, 16, 128, 40
    c, sc, ids, _ = _ivf_case(card, int8, block_n, n_blocks)
    q = torch.from_numpy(_unit(nq, 64, 13)).to(card).bfloat16()
    gen = torch.Generator().manual_seed(14)
    probes = torch.stack([torch.randperm(n_blocks, generator=gen)[:nprobe]
                          for _ in range(nq)]).to(card, torch.int32)
    call = _ivf_call(int8, union)
    for k in (20, 300):
        if union:
            table, nu = union_blocks(probes)
            args = (table, k, block_n, nu)
            want = V.ivf_union_plain(c, ids, q, *args, scales=sc)
        else:
            args = (probes, k, block_n)
            want = V.ivf_probed_plain(c, ids, q, *args, scales=sc)
        got = call(c, sc, ids, q, *args)
        again = call(c, sc, ids, q, *args)
        torch.cuda.synchronize()
        _same_ranking(got, want)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])
    z = V.launch_sizes(nq, args[0].shape[-1], block_n, 300, not union,
                       torch.cuda.get_device_properties(card)
                       .multi_processor_count,
                       n_blocks if union else None)
    assert z["chunk"] == 64
    assert z["ws_cols"] == (n_blocks if union else nprobe)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("union", [False, True])
def test_ivf_kernels_at_blocks_of_200_rows(card, int8, union):
    """Blocks of 200 rows (a ragged last tile, candidates not in 32-row
    runs), a repeated block: the rankings are the twins' at k 20 and
    300."""
    block_n = 200
    c, sc, ids, q = _ivf_case(card, int8, block_n)
    call = _ivf_call(int8, union)
    for k in (20, 300):
        if union:
            table = torch.tensor([1, 2, 5, 9, 12, 2, 0], dtype=torch.int32,
                                 device=card)
            args = (table, k, block_n,
                    torch.tensor([6], dtype=torch.int32, device=card))
            want = V.ivf_union_plain(c, ids, q, *args, scales=sc)
        else:
            table = torch.tensor([[2, 5, 5, 7]] * 6, dtype=torch.int32,
                                 device=card)
            args = (table, k, block_n)
            want = V.ivf_probed_plain(c, ids, q, *args, scales=sc)
        got = call(c, sc, ids, q, *args)
        torch.cuda.synchronize()
        _same_ranking(got, want)


def test_ivf_scan_builds_without_spills(card):
    """ptxas (``scripts/kernel_resources.py``) reports no spill stores or
    loads and no stack for any instance of the scan (bf16 and int8 rows,
    one to four n8 query tiles) or for the selection."""
    from pathlib import Path

    from cmw_rag_tpu_torch.scripts import kernel_resources as KR

    _, kernels = KR.compile_source(Path(__file__).resolve().parents[1],
                                   "ivf_scan")
    scan = [k for k in kernels if "ivf_scan_kernel" in k["kernel"]]
    select = [k for k in kernels if "select_kernel" in k["kernel"]]
    assert len(scan) == 6 and len(select) == 1, [k["kernel"] for k in kernels]
    for k in scan + select:
        assert (k["spill_stores"], k["spill_loads"], k["stack"]) \
            == (0, 0, 0), k


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


#: the paged kernel's split: the host's rule (None, through the wrappers),
#: a divisor or multiple of the page short of one stage (32), and four
#: stages of the ring (256)
PAGED_TEST_SPLITS = [None, 32, 256]


def _paged_edge_case(card, rep, dh, page, split, seed):
    """Lengths 1, 63, 64, 65, split - 1, split, split + 1, 2047 and 2048
    (split the one in force) over tables of 2048 positions, then the idle
    slot; Hkv 2. → (q, pools, tables, lens, the lengths)."""
    hkv, maxp = 2, 2048 // page
    s = 1 + 10
    sp = split or PA.paged_split(s, hkv, maxp, page,
                                 PA.sm_count(card),
                                 PA._resident(False, dh, rep, card))
    lens = sorted({1, 63, 64, 65, sp - 1, sp, sp + 1, 2047, 2048} - {0})
    q, kp, vp, tables, lens_t = _paged_case(card, len(lens) + 1, rep * hkv,
                                            hkv, dh, page, maxp, lens,
                                            seed=seed, layers=1)
    return q, kp, vp, tables, lens_t, lens


@pytest.mark.parametrize("rep,dh,page", [(1, 128, 64), (2, 128, 64),
                                         (4, 64, 16), (8, 128, 256),
                                         (2, 64, 256), (2, 128, 16),
                                         (2, 128, 512), (2, 64, 512)])
@pytest.mark.parametrize("kind", ["dma", "scatter", "int8"])
@pytest.mark.parametrize("paged_split", PAGED_TEST_SPLITS)
def test_paged_attention_at_split_and_page_boundaries(card, paged_split, rep,
                                                      dh, page, kind):
    """Boundary lengths and an idle slot against the twin (bf16 and int8
    pages, the fused write; pages up to 512); a second launch bit for bit
    the first; rows past every length poisoned (NaN for bf16, page scales
    NaN and rows scrambled for int8) change nothing; the scatter kernel
    takes the row of position lens - 1 from k_new/v_new (that pool row NaN
    before the call) and leaves the pools bit for bit the twin's. A split
    other than the rule's goes to the kernel's launch, not a wrapper."""
    q, kp, vp, tables, lens, lens_list = _paged_edge_case(
        card, rep, dh, page, paged_split, seed=rep * dh + page)
    s, hkv, act = q.shape[0], kp.shape[3], slice(0, q.shape[0] - 1)
    if kind == "int8":
        kq, ks = PA.quantize_kv_page(kp)
        vq, vs = PA.quantize_kv_page(vp)

        def run():
            if paged_split:
                return PA._launch(q, kq, vq, 0, tables, lens, k_scales=ks,
                                  v_scales=vs, split=paged_split)
            return PA.paged_decode_attention_dma_kv_int8(q, kq, ks, vq, vs,
                                                         tables, lens, layer=0)
        want = PA.paged_decode_attention_dma_kv_int8(
            q.cpu(), kq.cpu(), ks.cpu(), vq.cpu(), vs.cpu(), tables.cpu(),
            lens.cpu(), layer=0).to(card)
        tol = 2e-2
    elif kind == "scatter":
        gen = torch.Generator(device=card).manual_seed(s)
        k_new = torch.randn((s, hkv, dh), generator=gen, device=card).bfloat16()
        v_new = torch.randn((s, hkv, dh), generator=gen, device=card).bfloat16()
        pos = (lens - 1).long()
        pi = tables.long().gather(1, (pos // page)[:, None])[:, 0]
        off = pos % page
        want, k_want, v_want = PA.paged_decode_attention_dma_scatter(
            q.cpu(), k_new.cpu(), v_new.cpu(), pi.int().cpu(), off.int().cpu(),
            kp.cpu(), vp.cpu(), tables.cpu(), lens.cpu(), layer=0)
        want = want.to(card)
        kp[0, pi, off] = float("nan")      # stale: never read from the pool
        vp[0, pi, off] = float("nan")

        def run():
            if paged_split:
                return PA._launch(q, kp, vp, 0, tables, lens, k_new=k_new,
                                  v_new=v_new, page_idx=pi.int(),
                                  off=off.int(), split=paged_split)
            return PA.paged_decode_attention_dma_scatter(
                q, k_new, v_new, pi.int(), off.int(), kp, vp, tables, lens,
                layer=0)[0]
        tol = 1e-5
    else:
        def run():
            if paged_split:
                return PA._launch(q, kp, vp, 0, tables, lens,
                                  split=paged_split)
            return PA.paged_decode_attention_dma(q, kp, vp, tables, lens,
                                                 layer=0)
        want = PA.paged_decode_attention_dma(q.cpu(), kp.cpu(), vp.cpu(),
                                             tables.cpu(), lens.cpu(),
                                             layer=0).to(card)
        tol = 1e-5
    got = run()
    again = run()
    torch.cuda.synchronize()
    if kind == "scatter":
        assert torch.equal(kp.cpu(), k_want) and torch.equal(vp.cpu(), v_want)
    err = (got[act].float() - want[act].float()).abs()
    assert (err <= _bf16_step(want[act]) + tol).all(), err.max().item()
    assert torch.equal(got, again)
    if kind == "int8":
        for si, n in enumerate(lens_list):
            for j, pg in enumerate(tables[si].tolist()):
                start = min(max(n - j * page, 0), page)
                kq[0, pg, start:] = -127
                vq[0, pg, start:] = 127
                if start == 0:
                    ks[0, pg] = float("nan")
                    vs[0, pg] = float("nan")
    else:
        _poison_past((kp, vp), 0, lens_list, tables, page)
    after = run()
    torch.cuda.synchronize()
    assert torch.equal(after[act], got[act])


def _cuda_kernels(fn, iters=1):
    """The names of the CUDA kernels ``iters`` calls of ``fn`` run, under
    torch.profiler (``profile_query.kernel_window``): after one warm-up call
    (which makes the workspace) and a warm-up profiler step (which turns
    the device tracing on before the window opens), with host time at the
    window's edges; a window that recorded no kernel at all (the profiler
    on the card loses some, PERF.md §7) is taken again, three in all."""
    from cmw_rag_tpu_torch.scripts.profile_query import kernel_window

    events, _ = kernel_window(fn, iters)
    return [e.name for e in events]


def test_every_paged_wrapper_runs_one_kernel_a_call(card):
    """#14-#18 and #20 (and the scatter wrapper's batched schedule) at the
    serving shape, where each (slot, KV head) has many splits: each call
    runs exactly one kernel, the paged kernel; an empty profile fails."""
    q, kp, vp, tables, lens = _paged_case(card, 4, 16, 8, 128, 64, 32,
                                          [1, 63, 2047], seed=7)
    kq, ks = PA.quantize_kv_page(kp)
    vq, vs = PA.quantize_kv_page(vp)
    pos = (lens - 1).long()
    pi = tables.long().gather(1, (pos // 64)[:, None])[:, 0].int()
    off = (pos % 64).int()
    new = kp[0, 1, :4].contiguous()
    calls = {
        "dma": lambda: PA.paged_decode_attention_dma(q, kp, vp, tables, lens,
                                                     layer=0),
        "scatter": lambda: PA.paged_decode_attention_dma_scatter(
            q, new, new, pi, off, kp, vp, tables, lens, layer=0),
        "scatter-batched": lambda: PA.paged_decode_attention_dma_scatter(
            q, new, new, pi, off, kp, vp, tables, lens, layer=0,
            batched=True),
        "int8": lambda: PA.paged_decode_attention_dma_kv_int8(
            q, kq, ks, vq, vs, tables, lens, layer=0),
        "one-layer": lambda: PA.paged_decode_attention(q, kp[0], vp[0],
                                                       tables, lens),
        "pooled": lambda: PA.paged_decode_attention_pooled(q, kp, vp, tables,
                                                           lens, layer=0),
        "batched": lambda: PA.paged_decode_attention_dma_batched(
            q, kp, vp, tables, lens, layer=0)}
    for label, call in calls.items():
        names = _cuda_kernels(call, iters=3)
        assert len(names) == 3, (label, names)
        assert all("paged_decode_kernel" in n for n in names), (label, names)


def test_paged_attention_refuses_an_odd_box_of_int8_rows(card):
    """int8 pages at Dh 64 with an odd page give TMA boxes of an odd number
    of 64-byte rows, off the 128-byte grain: refused before any launch; bf16
    pages of the same shape are served."""
    q, kp, vp, tables, lens = _paged_case(card, 3, 4, 2, 64, 5, 8, [3, 40],
                                          seed=11, layers=1)
    kq, ks = PA.quantize_kv_page(kp)
    vq, vs = PA.quantize_kv_page(vp)
    n0 = PA.paged_decode_attention_dma_kv_int8.launches
    with pytest.raises(ValueError, match="128 bytes"):
        PA.paged_decode_attention_dma_kv_int8(q, kq, ks, vq, vs, tables, lens,
                                              layer=0)
    assert PA.paged_decode_attention_dma_kv_int8.launches == n0
    got = PA.paged_decode_attention_dma(q, kp, vp, tables, lens, layer=0)
    want = PA.paged_decode_attention_dma(q.cpu(), kp.cpu(), vp.cpu(),
                                         tables.cpu(), lens.cpu(), layer=0)
    err = (got[:2].float().cpu() - want[:2].float()).abs()
    assert (err <= _bf16_step(want[:2]) + 1e-5).all(), err.max().item()


def test_paged_and_slot_kernels_on_two_streams(card):
    """Two streams launching at once each get their own workspace (partials
    and merge counters) and the answer one stream gives alone, bit for
    bit."""
    q, kp, vp, tables, lens = _paged_case(card, 4, 16, 8, 128, 64, 32,
                                          [1, 63, 2047], seed=8)
    q2 = q.flip(0).contiguous()
    slot_lens = torch.tensor([1, 100, 384, 250], dtype=torch.int32,
                             device=card)

    def paged(x):
        return PA.paged_decode_attention_dma(x, kp, vp, tables, lens, layer=0)

    def slot(x):
        return PA.paged_decode_attention_dma_slot(x, kp, vp, slot_lens,
                                                  layer=0, cap=6, maxp_slot=32)
    want = {(f.__name__, i): f(x) for f in (paged, slot)
            for i, x in enumerate((q, q2))}
    streams = (torch.cuda.Stream(card), torch.cuda.Stream(card))
    outs = {}
    torch.cuda.synchronize()
    for rnd in range(20):
        for i, (st, x) in enumerate(zip(streams, (q, q2))):
            with torch.cuda.stream(st):
                for f in (paged, slot):
                    outs[(f.__name__, i, rnd)] = f(x)
    torch.cuda.synchronize()
    for (name, i, _), got in outs.items():
        assert torch.equal(got, want[(name, i)]), name
    keys = [(card.index or 0, st.cuda_stream) for st in streams]
    ws = [PA._WORKSPACES[k] for k in keys]
    assert ws[0][0].data_ptr() != ws[1][0].data_ptr()
    assert ws[0][1].data_ptr() != ws[1][1].data_ptr()
    assert not any(w[1].any() for w in ws)     # every launch left them 0


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


@pytest.fixture(params=[64, 128])
def attn_split(request, monkeypatch):
    """The split attention kernels' split (positions), both sizes."""
    monkeypatch.setattr(PA, "ATTN_SPLIT", request.param)
    return request.param


def _split_lens(split, page):
    """Lengths on either side of every split boundary up to a cap of whole
    pages past 2 split + 1, the cap's full length last; → (lens, cap)."""
    cap = -(-(2 * split + 1) // page) + 1
    return [1, split - 1, split, split + 1, 2 * split + 1, cap * page], cap


def _poison_past(pools, layer, lens, tables, page):
    """NaN in every row at or past each slot's length, over its table."""
    for si, n in enumerate(lens):
        for j, pg in enumerate(tables[si].tolist()):
            start = min(max(n - j * page, 0), page)
            for pool in pools:
                pool[layer, pg, start:] = float("nan")


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


@pytest.mark.parametrize("hq,hkv,dh,page", [(16, 8, 128, 64), (4, 4, 64, 16)])
def test_slot_attention_at_split_boundaries(card, attn_split, hq, hkv, dh,
                                            page):
    """Boundary lengths and an idle slot against the twin; a second launch
    bit for bit the first; NaN past every length changes nothing."""
    lens, cap = _split_lens(attn_split, page)
    lens = lens + [1]                                    # the idle slot
    s, maxp = len(lens), cap + 1
    q, kp, vp = _slot_case(card, s, hq, hkv, dh, page, maxp, seed=cap)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    got = PA.paged_decode_attention_dma_slot(q, kp, vp, lens_t, layer=1,
                                             cap=cap, maxp_slot=maxp)
    want = PA.paged_decode_attention_slot_plain(q, kp[1], vp[1], lens_t, cap,
                                                maxp)
    again = PA.paged_decode_attention_dma_slot(q, kp, vp, lens_t, layer=1,
                                               cap=cap, maxp_slot=maxp)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert (err <= _bf16_step(want) + 1e-5).all(), err.max().item()
    assert torch.equal(got, again)
    _poison_past((kp, vp), 1, lens, PA.slot_tables(s, maxp, maxp), page)
    after = PA.paged_decode_attention_dma_slot(q, kp, vp, lens_t, layer=1,
                                               cap=cap, maxp_slot=maxp)
    torch.cuda.synchronize()
    assert torch.equal(after, got)


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


@pytest.mark.parametrize("s,d,a,f", [
    *[(s, 1024, 2048, 3072) for s in (1, 4, 8, 9, 16, 17, 32, 40)],
    (1, 256, 512, 384), (40, 256, 128, 192)])
def test_fused_mlp_matches_plain_twin(card, s, d, a, f):
    """The fused MLP against its twin at qwen3guard-0.6b's width on either
    side of each row tile (8, 16) and at two and three 16-row tiles, and
    at small widths (F 192: half a column tile; A 128: two stages): within
    the tolerance, bit for bit on a second launch, one kernel a call."""
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
    names = _cuda_kernels(
        lambda: FM.fused_mlp_int8(x, attn, *[lay[k] for k in MLP]))
    assert len(names) == 1 and "fused_mlp_kernel" in names[0], names


def _layer_case(card, case):
    """A megakernel call: → (args before the pools, k_pools, v_pools,
    lens, route keywords, tables)."""
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
    return args, kp, vp, lens_t, kw, tables


def _check_layer(card, case):
    """The megakernel against its twin: output, the written rows, every
    other row unchanged. → (args, pools, lens, keywords, tables, output)."""
    s = case[0]
    args, kp, vp, lens_t, kw, tables = _layer_case(card, case)
    page_idx, off = args[-2], args[-1]
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
    return args, (kp, vp), lens_t, kw, tables, got


@pytest.mark.parametrize("case", [
    # S, Hq, Hkv, Dh, D, F, page, maxp, lens, slot-major
    (4, 16, 8, 128, 1024, 3072, 64, 32, [63, 200, 384], True),
    (4, 16, 8, 128, 1024, 3072, 64, 32, [1, 700, 2047], False),
    (9, 8, 2, 64, 256, 384, 16, 4, [1, 16, 17, 30, 33, 48, 63, 64], False),
    (3, 8, 2, 64, 256, 384, 16, 4, [5, 40], True)])
def test_decoder_layer_matches_plain_twin(card, case, attn_split):
    _check_layer(card, case)


@pytest.mark.parametrize("slot", [True, False])
def test_decoder_layer_at_split_boundaries(card, attn_split, slot):
    """Boundary lengths and an idle slot against the twin on both routes;
    a second launch (which rewrites the same rows) bit for bit the first;
    NaN in every row past each length changes nothing."""
    page = 64
    lens, cap = _split_lens(attn_split, page)
    case = (len(lens) + 1, 16, 8, 128, 1024, 3072, page, cap, lens, slot)
    args, pools, lens_t, kw, tables, got = _check_layer(card, case)
    again = DL.decoder_layer_int8(*args, *pools, lens_t, layer=1, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _poison_past(pools, 1, lens, tables[:-1], page)
    after = DL.decoder_layer_int8(*args, *pools, lens_t, layer=1, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(after[:-1], got[:-1])


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


#: W8A8 shapes: phase 10's products (QKV, wo, gate-up, down, the head) at
#: 4 and 16 slots; rows on both sides of each fragment count and of the
#: 32-row m tile; columns off the 128-column tile
W8A8_CASES = ([(m, k, n) for m in (4, 16)
               for k, n in ((1024, 4096), (2048, 1024), (1024, 6144),
                            (3072, 1024), (1024, 151680))]
              + [(m, 1024, 4096) for m in (1, 3, 8, 9, 17, 32, 33)]
              + [(5, 256, 1040), (9, 1024, 4096 + 16), (1, 64, 16),
                 (33, 128, 512)])


@pytest.mark.parametrize("m,k,n", W8A8_CASES)
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
    assert torch.equal(got, IM.int8_matmul_w8a8(x, wq, ws))   # repeats exactly


def _w8a8_edge_rows(k):
    """Rows at the quantization's edges: zeros (the 1e-8 floor); x / scale
    exactly on halves of both signs (scale 1/16 exactly: round half to
    even); one large outlier; values far under the floor; a plain row."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, k)).astype(np.float32)
    x[0] = 0.0
    x[1] = ((np.arange(k) % 254) - 127 + 0.5) / 16   # (2j + 1) / 32: bf16
    x[1, 0] = 127 / 16                               # the absmax: scale 1/16
    x[2] = -x[1]
    x[3] *= 1e-2
    x[3, 7] = 1e4
    x[4] *= 1e-30
    return x


@pytest.mark.parametrize("k,n", [(1024, 4096), (256, 1040), (1024, 16384)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_matmul_at_the_quantization_edges(card, k, n, dtype):
    gen = torch.Generator(device=card).manual_seed(k + n)
    wq, ws = _q8(card, gen, k, n)
    x = torch.from_numpy(_w8a8_edge_rows(k)).to(card).to(dtype)
    xq, _ = IM.quantize_activations(x)
    halves = xq[1, 1:].long().cpu()
    assert (halves % 2 == 0).all() and xq[0].eq(0).all() and xq[4].eq(0).all()
    got = IM.int8_matmul_w8a8(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, IM.int8_matmul_w8a8_plain(x, wq, ws))
    assert got[0].eq(0).all()


@pytest.mark.parametrize("m,k,n", [(4, 1024, 4096), (16, 3072, 1024),
                                   (3, 512, 1040), (33, 256, 640),
                                   (2, 17408, 256)])
def test_w8a8_every_split_gives_the_same_bits(card, m, k, n):
    """Integer partial sums merged in the launch: every split of the
    contraction (whole 64-row stages) gives the bits the host's split
    gives."""
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    wq, ws = _q8(card, gen, k, n)
    x = torch.randn((m, k), generator=gen, device=card).bfloat16()
    want = IM.int8_matmul_w8a8(x, wq, ws)
    steps = k // 64
    for split in sorted({1, 2, 3, 5, 8, 16, 48, steps}):
        if split <= steps:
            assert torch.equal(IM._w8a8_launch(x, wq, ws, split=split),
                               want), split
    assert torch.equal(want, IM.int8_matmul_w8a8_plain(x, wq, ws))


@pytest.mark.parametrize("m,k,n", [(4, 1024, 4096), (16, 1024, 151680)])
def test_w8a8_call_is_one_kernel_launch(card, m, k, n):
    """One wrapper call is one launch of the W8A8 kernel and nothing else
    on the card (no quantization ops, no combine kernel, no copy): three
    calls under torch.profiler record three kernels, each the W8A8 one. The
    first shape splits the contraction, the head's does not."""
    gen = torch.Generator(device=card).manual_seed(5)
    wq, ws = _q8(card, gen, k, n)
    x = torch.randn((m, k), generator=gen, device=card)
    x = x.to(torch.float32 if n > 100000 else torch.bfloat16)
    names = _cuda_kernels(lambda: IM.int8_matmul_w8a8(x, wq, ws), iters=3)
    assert len(names) == 3, names
    assert all("w8a8_mma_kernel" in name for name in names), names


def test_w8a8_on_two_streams(card):
    """Two streams calling at once each get their own workspace (partials
    and arrival counters) and the answer one stream gives alone, bit for
    bit; every launch leaves its counters 0."""
    gen = torch.Generator(device=card).manual_seed(6)
    wq, ws = _q8(card, gen, 1024, 4096)
    xs = [torch.randn((4, 1024), generator=gen, device=card).bfloat16()
          for _ in range(2)]
    want = [IM.int8_matmul_w8a8(x, wq, ws) for x in xs]
    streams = (torch.cuda.Stream(card), torch.cuda.Stream(card))
    outs = {}
    torch.cuda.synchronize()
    for rnd in range(20):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                outs[(i, rnd)] = IM.int8_matmul_w8a8(x, wq, ws)
    torch.cuda.synchronize()
    for (i, _), got in outs.items():
        assert torch.equal(got, want[i]), i
    spaces = [IM._WORKSPACES[(card.index or 0, st.cuda_stream)]
              for st in streams]
    assert spaces[0][0].data_ptr() != spaces[1][0].data_ptr()
    assert spaces[0][1].data_ptr() != spaces[1][1].data_ptr()
    assert not any(w[1].any() for w in spaces)


def test_w8a8_refuses_what_the_kernel_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(0)
    wq, ws = _q8(card, gen, 128, 64)
    x = torch.randn((2, 128), device=card)
    n0 = IM.int8_matmul_w8a8.launches
    with pytest.raises(TypeError):
        IM.int8_matmul_w8a8(x.half(), wq, ws)
    with pytest.raises(ValueError, match="multiple"):
        IM.int8_matmul_w8a8(x[:, :96].contiguous(), wq[:96].contiguous(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        IM.int8_matmul_w8a8(torch.randn((128, 2), device=card).t(), wq, ws)
    with pytest.raises(ValueError):
        IM.int8_matmul_w8a8(x, wq.cpu(), ws)
    with pytest.raises(ValueError, match="split"):
        IM._w8a8_launch(x, wq, ws, split=3)            # K has 2 stages
    assert IM.int8_matmul_w8a8.launches == n0


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


def _check_kv8(card, case):
    """The int8-KV megakernel against its twin: output, written rows and
    scales, every other row and scale unchanged. → (args, pools and
    planes, lens, tables, output)."""
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
    return args, (kq, ks, vq, vs), lens_t, tables, got[0]


@pytest.mark.parametrize("case", [
    # S, Hq, Hkv, Dh, D, F, page, maxp, lens (fresh pages among them)
    (4, 16, 8, 128, 1024, 3072, 64, 32, [65, 200, 384]),
    (4, 16, 8, 128, 1024, 3072, 64, 32, [2047, 129, 64]),
    (9, 8, 2, 64, 256, 384, 16, 4, [1, 16, 17, 30, 33, 48, 63, 64])])
def test_decoder_layer_kv8_matches_plain_twin(card, case, attn_split):
    _check_kv8(card, case)


def test_decoder_layer_kv8_at_split_boundaries(card, attn_split):
    """Boundary lengths and an idle slot against the twin; a second launch
    bit for bit the first."""
    lens, cap = _split_lens(attn_split, 64)
    case = (len(lens) + 1, 16, 8, 128, 1024, 3072, 64, cap, lens)
    args, (kq, ks, vq, vs), lens_t, tables, got = _check_kv8(card, case)
    again = DL.decoder_layer_int8_kv8(*args, kq, ks[1], vq, vs[1], lens_t,
                                      layer=1, tables=tables)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)


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


#: megakernel widths by head dim: (Hq, Hkv, D, F, page); qwen3guard-0.6b's
#: at Dh 128, a small model's at Dh 64
MEGA_WIDTHS = {128: (16, 8, 1024, 3072, 64), 64: (8, 2, 256, 384, 16)}
#: (int8 pages, rows, route): 1, 4 and 8 rows on both routes, 16 and 32
#: on the paged one (the forced paged route's row tiles); int8 pages take
#: the paged route only
MEGA_ROWS = ([(False, s, "slot") for s in (1, 4, 8)]
             + [(kv8, s, "paged") for kv8 in (False, True)
                for s in (1, 4, 8, 16, 32)])


def _mega_case(card, s, dh, route, kv8, seed, maxp=8):
    """A megakernel call with every one of ``s`` slots active, each at its
    own length (short, on either side of a page, the whole table), on the
    slot-major (``route`` "slot") or paged route, bf16 or int8 pages: →
    (args before the pools, pools (int8: with their [L, P, Hkv] scales),
    lens, route keywords, tables)."""
    hq, hkv, d, f, page = MEGA_WIDTHS[dh]
    gen = torch.Generator(device=card).manual_seed(seed)
    lay = _layer(card, gen, d, hq, hkv, dh, f)
    n_pages = 1 + s * maxp
    shape = (2, n_pages, page, hkv, dh)
    full = maxp * page
    lens = [(1, page - 1, page + 1, full, 2 * page, 3)[i % 6] + i % 3
            for i in range(s)]
    lens = [min(n, full) for n in lens]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=card)
    if route == "slot":
        tables = PA.slot_tables(s, maxp, maxp, 1, card)
        kw = dict(attn_slot=True, slot_cap=-(-max(lens) // page),
                  slot_maxp=maxp)
    else:
        tables = (torch.randperm(n_pages - 1, generator=gen, device=card)
                  + 1).reshape(s, maxp).to(torch.int32)
        kw = dict(tables=tables)
    pos = (lens_t - 1).long()
    page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    off = (pos % page).to(torch.int32)
    if kv8:
        kq, ks = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                                 device=card))
        vq, vs = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                                 device=card))
        pools = (kq, ks, vq, vs)
    else:
        pools = (torch.randn(shape, generator=gen, device=card).bfloat16(),
                 torch.randn(shape, generator=gen, device=card).bfloat16())
    x = torch.randn((s, d), generator=gen, device=card).bfloat16()
    ang = torch.rand((s, dh // 2), generator=gen, device=card) * 6.28
    c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
    args = (x, c2, s2, *[lay[k] for k in LAYER], page_idx.to(torch.int32),
            off)
    return args, pools, lens_t, kw, tables


def _mega_call(args, pools, lens_t, kw, kv8, ablate=""):
    """One megakernel (or twin, ``plain``) call over layer 1: → (output,
    the pools and planes as the call left them)."""
    if kv8:
        kq, ks, vq, vs = pools
        out = DL.decoder_layer_int8_kv8(*args, kq, ks[1], vq, vs[1], lens_t,
                                        layer=1, ablate=ablate, **kw)[0]
    else:
        out = DL.decoder_layer_int8(*args, *pools, lens_t, layer=1,
                                    ablate=ablate, **kw)[0]
    return out


def _mega_twin(args, pools, lens_t, kw, kv8, ablate=""):
    if kv8:
        kq, ks, vq, vs = pools
        return DL.decoder_layer_int8_kv8_plain(
            *args, kq, ks[1], vq, vs[1], lens_t, layer=1, ablate=ablate,
            **kw)[0]
    return DL.decoder_layer_int8_plain(*args, *pools, lens_t, layer=1,
                                       ablate=ablate, **kw)[0]


def _mega_reference(card, args, pools, ieee_pools, lens_t, kw, kv8,
                    ablate=""):
    """The megakernel card tests' reference: the twin with the QKV product
    on the tensor cores' model and the head norms and RoPE in the kernel's
    order (``tensor_core_model``), over ``pools`` (written in place), held
    against the plain IEEE twin over copies of ``ieee_pools``: their
    attention outputs within ``ATTENTION_STEPS`` bf16 step at each head's
    largest |value| (``head_steps_apart``), their outputs within that gap
    carried through wo and the MLP (``carried_step_bound``). → (reference
    output, IEEE twin's output)."""
    x, wqkv_q, down_q = args[0], args[4], args[13]
    hkv, dh = pools[0].shape[3], pools[0].shape[4]
    hq = wqkv_q.shape[1] // dh - 2 * hkv
    ks = TC.qkv_splits(card, x.shape[0], x.shape[1], hq, hkv, dh,
                       down_q.shape[0], kv8)
    want, a_ref = TC.run_twin(_mega_twin, args, pools, lens_t, kw, kv8,
                              ablate, ks=ks)
    ieee, a_ieee = TC.run_twin(_mega_twin, args,
                               [t.clone() for t in ieee_pools], lens_t, kw,
                               kv8, ablate)
    steps = TC.head_steps_apart(a_ref, a_ieee)
    assert steps <= TC.ATTENTION_STEPS, steps
    bound = TC.carried_step_bound(args, a_ref, a_ieee)
    apart = (want.float() - ieee.float()).abs()
    assert (apart <= bound).all(), float((apart - bound).max())
    return want, ieee


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("kv8,s,route", MEGA_ROWS)
def test_megakernels_at_every_row_tile_route_and_head_dim(card, attn_split,
                                                          kv8, s, route, dh):
    """Both megakernels against their twins at 1 to 32 rows (row tiles of
    8 and 16; two of 16 at 32 rows), both routes (int8 pages: the paged one), Dh 64 and 128:
    the output, the written rows (and int8 pages' scales) within the
    tolerances, every other row and scale bit for bit; a second launch bit
    for bit the first; NaN in every row past each length (bf16 pages)
    changes nothing."""
    args, pools, lens_t, kw, tables = _mega_case(card, s, dh, route, kv8,
                                                 seed=s * 7 + dh)
    page = MEGA_WIDTHS[dh][4]
    before = [t.clone() for t in pools]
    twin_pools = [t.clone() for t in pools]
    n0 = (DL.decoder_layer_int8_kv8 if kv8 else DL.decoder_layer_int8).launches
    got = _mega_call(args, pools, lens_t, kw, kv8)
    want, ieee = _mega_reference(card, args, twin_pools, before, lens_t, kw,
                                 kv8)
    torch.cuda.synchronize()
    assert (DL.decoder_layer_int8_kv8 if kv8 else
            DL.decoder_layer_int8).launches == n0 + 1
    _close(got, want, 1e-3)
    page_idx, off = args[-2].long(), args[-1].long()
    rows = (page_idx, off)
    pool_idx = (0, 2) if kv8 else (0, 1)
    for i in pool_idx:
        pool, twin, old = pools[i], twin_pools[i], before[i]
        keep = torch.ones(pool.shape[:3], dtype=torch.bool, device=card)
        keep[1][rows] = False
        assert torch.equal(pool[keep], old[keep])
        if kv8:
            assert (pool[1][rows].int() - twin[1][rows].int()).abs().max() <= 1
        else:
            _close(pool[1][rows], twin[1][rows], 1e-3)
    if kv8:
        for i in (1, 3):
            plane, twin, old = pools[i], twin_pools[i], before[i]
            keep = torch.ones(plane.shape[:2], dtype=torch.bool, device=card)
            keep[1][page_idx] = False
            assert torch.equal(plane[keep], old[keep])
            assert ((plane[1][page_idx] - twin[1][page_idx]).abs()
                    <= _bf16_step(twin[1][page_idx])).all()
    again = _mega_call(args, pools, lens_t, kw, kv8)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if not kv8:
        _poison_past(pools, 1, lens_t.tolist(), tables, page)
        after = _mega_call(args, pools, lens_t, kw, kv8)
        torch.cuda.synchronize()
        assert torch.equal(after, got)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s", [4, 16])
@pytest.mark.parametrize("kv8", [False, True])
def test_megakernels_noattn_at_both_head_dims(card, s, dh, kv8):
    """The ablation (the attention output is q) against the twin's."""
    args, pools, lens_t, kw, _ = _mega_case(card, s, dh, "paged", kv8,
                                            seed=s + dh)
    got = _mega_call(args, [t.clone() for t in pools], lens_t, kw, kv8,
                     ablate="noattn")
    want, _ = _mega_reference(card, args, [t.clone() for t in pools], pools,
                              lens_t, kw, kv8, ablate="noattn")
    torch.cuda.synchronize()
    _close(got, want, 1e-3)


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("s", [4, 32])
def test_megakernels_run_one_kernel_a_call(card, kv8, s):
    """A megakernel call is one launch of the megakernel and nothing else
    (its workspace is made once, the weights' maps once)."""
    args, pools, lens_t, kw, _ = _mega_case(card, s, 128, "paged", kv8,
                                            seed=3)
    names = _cuda_kernels(lambda: _mega_call(args, pools, lens_t, kw, kv8))
    assert len(names) == 1 and "decoder_layer_kernel" in names[0], names


def test_megakernels_build_without_spills(card):
    """ptxas (``scripts/kernel_resources.py``) reports no spill stores or
    loads and no stack for any instance of either megakernel or of the
    fused MLP on their weight phases."""
    from pathlib import Path

    from cmw_rag_tpu_torch.scripts import kernel_resources as KR

    root = Path(__file__).resolve().parents[1]
    for stem, name, n in (("decoder_layer", "decoder_layer_kernel", 4),
                          ("decoder_layer_kv8", "decoder_layer_kernel", 4),
                          ("fused_mlp", "fused_mlp_kernel", 2)):
        _, kernels = KR.compile_source(root, stem)
        mega = [k for k in kernels if name in k["kernel"]]
        assert len(mega) == n, [k["kernel"] for k in kernels]
        for k in mega:
            assert (k["spill_stores"], k["spill_loads"], k["stack"]) \
                == (0, 0, 0), k


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
