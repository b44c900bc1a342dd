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
its log-sum-exp to 1e-4 (float32 on both sides).
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu_torch.index.flat import FlatIndex
from cmw_rag_tpu_torch.index.ivf import IVFIndex
from cmw_rag_tpu_torch.index.shards import SegmentedIndex
from cmw_rag_tpu_torch.ops import flash_attention as F
from cmw_rag_tpu_torch.ops import ivf_scan as V
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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_twin(card, d, causal):
    g = torch.Generator(device=card).manual_seed(d + causal)
    b, h, L = 2, 3, 192
    q, k, v = (torch.randn((b * h, L, d), generator=g, device=card)
               .bfloat16() for _ in range(3))
    mask = torch.ones((b, L), dtype=torch.int32, device=card)
    mask[1, 130:] = 0
    before = F.flash_attention_fwd.launches
    o, lse = F.flash_attention_fwd(q, k, v, mask, h, causal)
    tile = F.kernel_tile()
    po, pl = F.flash_attention_plain(q, k, v, mask, h, causal, tile, tile)
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


def test_flash_wrappers_refuse_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 100, 64), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 100), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple"):
        F.flash_attention_fwd(q, q, q, mask, 2)
    q = torch.zeros((2, 128, 48), dtype=torch.bfloat16, device=card)
    mask = torch.ones((1, 128), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
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
