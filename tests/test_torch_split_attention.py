"""Split decode attention (flash-decoding) of the port's slot-major kernel
and decoder-layer megakernels, on the CPU: the plain model of the split and
the merge (``paged_attention.paged_decode_attention_split_plain``) against
the twin the kernels are held to on the card
(``paged_decode_attention_slot_plain``), against JAX's gather golden
(``cmw_rag_tpu.ops.paged_attention.paged_decode_attention_xla``) and
against JAX's slot-major Pallas kernel in interpret mode, all within 2e-5
in float32 (the model only adds the splits' float32 sums in another order;
the JAX test holds its kernel to the golden at 2e-5). Lengths on either
side of every split boundary, splits past the length (which carry
m = -inf and weigh 0), and NaN in every row past the length, which leaves
the model's output as it was. The host's sizing of the splits and the
scratch (what the card's grid and buffers get) is checked against the
kernels' rule: ceil(positions / split), at least one. The paged kernel's
split rule (``paged_split``: from the table width and the resident
blocks) at phase 8's and the engine's shapes, and the workspace cache a
(device, stream) with stand-in keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops.paged_attention import (
    paged_decode_attention_dma_slot as jax_slot_kernel,
    paged_decode_attention_xla as jax_golden)
from cmw_rag_tpu_torch.ops import paged_attention as PA

TOL = 2e-5
S_HQ_HKV_DH_PAGE = (8, 2, 64, 16)


def _boundary_lens(split: int, cap: int, page: int) -> list[int]:
    """1, split - 1, split, split + 1, 2 split + 1 and cap * page (the
    boundary lengths of the card tests), then an idle slot of length 1."""
    return [1, split - 1, split, split + 1, 2 * split + 1, cap * page, 1]


def _case(split: int, seed: int):
    hq, hkv, dh, page = S_HQ_HKV_DH_PAGE
    cap = -(-(2 * split + 1) // page) + 1
    lens = _boundary_lens(split, cap, page)
    s, maxp = len(lens), cap + 1
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, hq, dh)).astype(np.float32)
    kp = rng.normal(size=(1, 1 + s * maxp, page, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(1, 1 + s * maxp, page, hkv, dh)).astype(np.float32)
    return q, kp, vp, np.asarray(lens, np.int32), cap, maxp


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("split", [16, 32, 64])
def test_split_model_matches_twin_and_jax_golden(split):
    q, kp, vp, lens, cap, maxp = _case(split, seed=split)
    tables = PA.slot_tables(len(lens), cap, maxp)
    got = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), tables, _t(lens), split)
    twin = PA.paged_decode_attention_slot_plain(_t(q), _t(kp[0]), _t(vp[0]),
                                                _t(lens), cap, maxp)
    golden = jax_golden(jnp.asarray(q), jnp.asarray(kp[0]),
                        jnp.asarray(vp[0]), jnp.asarray(tables.numpy()),
                        jnp.asarray(lens))
    assert got.shape == twin.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(golden), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("split", [16, 32])
def test_split_model_matches_jax_slot_kernel(split):
    """JAX's slot-major kernel, run in interpret mode as its own tests run
    it, over the same partitioned pools."""
    q, kp, vp, lens, cap, maxp = _case(split, seed=100 + split)
    want = jax_slot_kernel(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(lens), layer=0, cap=cap,
                           maxp_slot=maxp, interpret=True)
    got = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), PA.slot_tables(len(lens), cap, maxp),
        _t(lens), split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("split", [16, 32])
def test_split_model_never_weighs_rows_past_the_length(split):
    """NaN in every row at or past a slot's length, and in the pages past
    its cap, leave the output bit for bit as it was, and finite."""
    q, kp, vp, lens, cap, maxp = _case(split, seed=200 + split)
    page = kp.shape[2]
    tables = PA.slot_tables(len(lens), cap, maxp)
    want = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), tables, _t(lens), split)
    for si, n in enumerate(lens.tolist()):
        for j in range(maxp):
            start = min(max(n - j * page, 0), page)
            kp[0, 1 + si * maxp + j, start:] = np.nan
            vp[0, 1 + si * maxp + j, start:] = np.nan
    got = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), tables, _t(lens), split)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_splits_past_the_length_weigh_nothing():
    """A table far wider than the contexts (most splits empty) gives what
    the narrowest table that holds them gives, and one split as wide as the
    context gives the unsplit softmax."""
    q, kp, vp, lens, cap, maxp = _case(16, seed=7)
    narrow = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), PA.slot_tables(len(lens), cap, maxp),
        _t(lens), 16)
    wide = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), PA.slot_tables(len(lens), maxp, maxp),
        _t(lens), 16)
    whole = PA.paged_decode_attention_split_plain(
        _t(q), _t(kp[0]), _t(vp[0]), PA.slot_tables(len(lens), cap, maxp),
        _t(lens), 128)
    np.testing.assert_allclose(wide.numpy(), narrow.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(whole.numpy(), narrow.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("positions,split,n_split", [
    (1, 64, 1), (63, 64, 1), (64, 64, 1), (65, 64, 2), (129, 64, 3),
    (384, 64, 6), (384, 128, 3), (2048, 64, 32), (2048, 128, 16),
    (0, 64, 1), (96, 16, 6)])
def test_split_sizing_follows_the_kernels_rule(positions, split, n_split):
    assert PA.attention_splits(positions, split) == n_split
    n, shape, counts = PA.split_scratch(4, 8, 2, 128, positions, split)
    assert (n, shape, counts) == (n_split, (4, 8, n_split, 2, 130), 32)


def test_split_sizing_of_the_main_paths():
    """What the card's grids get at phase 9's shapes: the slot kernel at 4
    slots, cap 6 of 64-row pages, and the megakernel's paged route over a
    32-page table; only the host's cap and table width enter, never the
    lengths (which stay on the device)."""
    for split, slot_n, paged_n in ((64, 6, 32), (128, 3, 16)):
        n, shape, counts = PA.split_scratch(4, 8, 2, 128, 6 * 64, split)
        assert n == slot_n and shape == (4, 8, slot_n, 2, 130)
        assert counts == 32
        assert PA.split_scratch(4, 8, 2, 128, 32 * 64, split)[0] == paged_n
    with pytest.raises(ValueError):
        PA.attention_splits(100, 129)
    with pytest.raises(ValueError):
        PA.attention_splits(100, 0)


# (S, Hkv, maxp, page): phase 8's three shapes (4 x 2048, 8 x 1024 and
# 32 x 1024 of qwen3guard-0.6b's 8 KV heads) and the engine's 4- and
# 16-slot tables (2048 and 1024 positions)
PAGED_SHAPES = {"serving": (4, 8, 32, 64), "bench": (8, 8, 16, 64),
                "s32": (32, 8, 16, 64), "engine-s16": (16, 8, 16, 64)}


@pytest.mark.parametrize("per_sm", [2, 4, 6])
@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
def test_paged_split_rule_at_the_main_shapes(shape, per_sm):
    """The paged kernel's split: a multiple of the page or a divisor of
    it, at least PAGED_MIN_SPLIT, the narrowest whose work items fit
    PAGED_WAVES waves of the H100's 132 SMs' resident blocks (or the whole
    table)."""
    s, hkv, maxp, page = PAGED_SHAPES[shape]
    split = PA.paged_split(s, hkv, maxp, page, 132, per_sm)
    positions = maxp * page
    assert split % page == 0 or page % split == 0
    assert PA.PAGED_MIN_SPLIT <= split <= positions

    def items(n):
        return s * hkv * -(-positions // n)
    room = PA.PAGED_WAVES * 132 * per_sm
    assert items(split) <= room or split == positions
    narrower = [n for n in range(PA.PAGED_MIN_SPLIT, split)
                if n % page == 0 or page % n == 0]
    assert all(items(n) > room for n in narrower)


@pytest.mark.parametrize("s,hkv,maxp,page,per_sm,split", [
    (4, 8, 32, 64, 4, 64), (8, 8, 16, 64, 4, 64), (32, 8, 16, 64, 4, 256),
    (16, 8, 16, 64, 4, 128), (16, 8, 32, 64, 4, 256),
    (4, 8, 32, 64, 2, 128), (32, 8, 16, 64, 2, 512),
    (2, 2, 128, 16, 1, 64), (2, 2, 8, 256, 1, 64), (3, 4, 6, 16, 1, 64),
    (1, 1, 2, 16, 1, 32), (2, 1, 1, 8, 1, 8), (64, 8, 4, 48, 1, 192)])
def test_paged_split_rule_values(s, hkv, maxp, page, per_sm, split):
    """Splits of pages of 16, 64 and 256 rows, a table narrower than one
    stage (the whole table) and a page that 64 does not divide (multiples
    of 48)."""
    assert PA.paged_split(s, hkv, maxp, page, 132, per_sm) == split


def test_split_workspace_is_one_a_key_and_grows_only_on_demand():
    """Stand-in keys for (device, stream): each key gets its own buffers;
    a call that needs no more than the key holds gets the same buffers
    back, allocating nothing; a larger call gets new, zeroed ones."""
    made = []

    def make(n, dtype):
        made.append((n, dtype))
        return torch.zeros((n,), dtype=dtype)
    cache = {}
    a_part, a_count = PA.split_workspace(cache, (0, 1), 100, 8, make)
    b_part, b_count = PA.split_workspace(cache, (0, 2), 100, 8, make)
    assert a_part.data_ptr() != b_part.data_ptr()
    assert a_count.data_ptr() != b_count.data_ptr()
    assert made == [(100, torch.float32), (8, torch.int32)] * 2
    assert a_count.dtype == torch.int32 and not a_count.any()
    again = PA.split_workspace(cache, (0, 1), 60, 4, make)
    assert again[0] is a_part and again[1] is a_count and len(made) == 4
    grown = PA.split_workspace(cache, (0, 1), 300, 8, make)
    assert grown[0].numel() == 300 and grown[1] is a_count
    assert made[-1] == (300, torch.float32)
    assert cache[(0, 2)] == (b_part, b_count)
