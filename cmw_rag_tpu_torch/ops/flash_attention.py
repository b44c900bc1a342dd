"""Flash attention, forward and backward: hand-written CUDA kernels and their
plain twins (port of ``cmw_rag_tpu/ops/flash_attention.py:92
flash_attention``, ``:306 _fa_forward``, the custom VJP ``:347
flash_attention_trainable`` with its backward ``:365 _fa_bwd_rule`` and the
model adapter ``:445 flash_attention_bhld``).

Semantics, shared by every function here and by the TPU kernels they
replace: q, k, v are [BH, L, D] with BH = B * num_heads; scores are
``(q . k) / sqrt(D)`` in float32; a key whose ``mask[b, key] <= 0`` (batch
row ``b = bh // num_heads``) and, when causal, a key after the query get
-1e30; softmax runs online over key blocks (running max ``m``, running sum
``l``, float32 accumulator), with the probabilities rounded to v's dtype
before the value product; causal key blocks wholly above the diagonal are
skipped. ``o = acc / max(l, 1e-30)`` in q's dtype, and the per-row
log-sum-exp is ``m + log(max(l, 1e-30))`` in float32, [BH, L, 1].

- ``flash_attention`` and ``flash_attention_fwd`` are the forward's
  wrappers (``flash_attention_bhld``, the model adapter, reaches the second
  through ``FlashAttentionTrainable``). On CUDA tensors they launch
  ``csrc/flash_attention.cu`` (bf16, D in {32, 64, 128}, L a multiple of its
  128-row tile ``TILE``; TMA, wgmma and a warp-specialised pipeline built
  from ``csrc/hopper.cuh``; its online softmax runs over 64-key blocks, so
  the twin's blocks are ``TILES``), each adding one to its own
  ``launches`` count per launch (``total_launches()`` sums the two); on CPU
  tensors they run the plain twin. Wrong device, dtype, shape, contiguity
  or alignment raises: there is no fallback.
- ``flash_attention_plain`` is the plain twin: the TPU kernel's arithmetic
  over blocks of ``block_q`` queries and ``block_k`` keys.
- The backward (``FlashAttentionTrainable``, a ``torch.autograd.Function``
  with the contract of ``flash_attention_trainable``) recomputes the
  probabilities from the forward's log-sum-exp, as ``_fa_bwd_rule``:
  ``delta = sum(float32(dO) * float32(O))`` over D (one torch op, as JAX
  computes it outside its kernels); ``p = exp(s - lse)`` with masked
  scores at -1e30; ``dp = float32(dO) . float32(V)^T``;
  ``ds = p * (dp - delta) * scale``; ``dQ`` accumulates ``bf16(ds) . K``
  (ds rounded to K's dtype), ``dK`` accumulates ``bf16(ds)^T . Q`` (to Q's
  dtype), ``dV`` accumulates ``p^T . float32(dO)`` with p kept in float32;
  float32 sums, outputs in the dtypes of q, k and v. Causal (query block,
  key block) pairs wholly above the diagonal are skipped by both kernels.
  ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` launch
  ``csrc/flash_attention_bwd.cu`` on CUDA tensors (same dtype, D and L
  rules as the forward), each with its own ``launches`` count, and run
  ``flash_attention_bwd_dq_plain`` / ``flash_attention_bwd_dkv_plain`` on
  CPU tensors; ``flash_attention_bwd_plain`` is the whole backward's twin.
"""

from __future__ import annotations

import ctypes

import torch

from cmw_rag_tpu_torch.device import on_cpu
from cmw_rag_tpu_torch.ops import cuda_build

NEG_INF = -1e30
#: query rows (and keys) per tile of the forward kernel: L must be a
#: multiple of it (``flash_attention_tile()`` in ``csrc/flash_attention.cu``)
TILE = 128
#: the twin's (block_q, block_k) that round p against the kernel's running
#: maxima: 128 query rows, 64-key online-softmax blocks
#: (``flash_attention_tiles()``)
TILES = (128, 64)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, num_heads: int,
                          causal: bool = False, block_q: int = 256,
                          block_k: int = 256):
    """Plain twin: → (o [BH, L, D] in q.dtype, lse [BH, L, 1] float32)."""
    bh, L, d = q.shape
    block_q, block_k = min(block_q, L), min(block_k, L)
    if L % block_q or L % block_k:
        raise ValueError(f"L={L} must be a multiple of block sizes")
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    keep = (mask > 0).repeat_interleave(num_heads, dim=0)        # [BH, L]
    q_pos = torch.arange(L, device=dev)
    q_block_end = (q_pos // block_q + 1) * block_q - 1           # [L]
    qf = q.float()
    m = torch.full((bh, L, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, L, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, L, d), dtype=torch.float32, device=dev)
    for k0 in range(0, L, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.einsum("bqd,bkd->bqk", qf, kb.float()) * scale
        s = torch.where(keep[:, None, k0:k0 + block_k], s,
                        torch.full_like(s, NEG_INF))
        if causal:
            k_pos = torch.arange(k0, k0 + block_k, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=2, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(), vb.float())
        if causal:  # query blocks whose rows all precede this key block skip it
            run = (k0 <= q_block_end)[None, :, None]
            m_new = torch.where(run, m_new, m)
            l_new = torch.where(run, l_new, l)
            acc_new = torch.where(run, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l).to(q.dtype), m + torch.log(l)


def _bwd_blocks(q, k, v, mask, do, lse, delta, num_heads, causal, block_q,
                block_k):
    """Yield ``(q0, p, ds, do_f32)`` for each block of ``block_q`` query rows:
    p and ds [BH, bq, L] float32 as the TPU backward kernels compute them,
    zero on the key blocks that their causal variants skip."""
    bh, L, d = q.shape
    block_q, block_k = min(block_q, L), min(block_k, L)
    if L % block_q or L % block_k:
        raise ValueError(f"L={L} must be a multiple of block sizes")
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    keep = (mask > 0).repeat_interleave(num_heads, dim=0)[:, None, :]
    k_pos = torch.arange(L, device=dev)
    kf, vf = k.float(), v.float()
    for q0 in range(0, L, block_q):
        rows = slice(q0, q0 + block_q)
        s = torch.einsum("bqd,bkd->bqk", q[:, rows].float(), kf) * scale
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        if causal:
            q_pos = torch.arange(q0, q0 + block_q, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[:, rows])
        dof = do[:, rows].float()
        dp = torch.einsum("bqd,bkd->bqk", dof, vf)
        ds = p * (dp - delta[:, rows]) * scale
        if causal:  # key blocks that start after this query block's last row
            run = (k_pos // block_k * block_k <= q0 + block_q - 1)[None, None]
            p = torch.where(run, p, torch.zeros_like(p))
            ds = torch.where(run, ds, torch.zeros_like(ds))
        yield q0, p, ds, dof


def flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta,
                                 num_heads: int, causal: bool = False,
                                 block_q: int = 256, block_k: int = 256):
    """Plain twin of the dQ kernel (``_flash_bwd_dq_kernel``): → dq
    [BH, L, D] in q.dtype. lse and delta are [BH, L, 1] float32."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    kf = k.float()
    for q0, _, ds, _ in _bwd_blocks(q, k, v, mask, do, lse, delta, num_heads,
                                    causal, block_q, block_k):
        dq[:, q0:q0 + ds.shape[1]] = torch.einsum(
            "bqk,bkd->bqd", ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta,
                                  num_heads: int, causal: bool = False,
                                  block_q: int = 256, block_k: int = 256):
    """Plain twin of the dK/dV kernel (``_flash_bwd_dkv_kernel``): →
    (dk in k.dtype, dv in v.dtype), [BH, L, D]."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0, p, ds, dof in _bwd_blocks(q, k, v, mask, do, lse, delta,
                                      num_heads, causal, block_q, block_k):
        qf = q[:, q0:q0 + ds.shape[1]].float()
        dv += torch.einsum("bqk,bqd->bkd", p, dof)
        dk += torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = sum(float32(dO) * float32(O))`` over D: [BH, L, 1] float32."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_bwd_plain(q, k, v, mask, o, lse, do, num_heads: int,
                              causal: bool = False, block_q: int = 256,
                              block_k: int = 256):
    """Plain twin of the whole backward (``_fa_bwd_rule``): → (dq, dk, dv)."""
    delta = bwd_delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta,
                                      num_heads, causal, block_q, block_k)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta,
                                           num_heads, causal, block_q,
                                           block_k)
    return dq, dk, dv


# ------------------------------------------------------------------ kernel


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_tile.argtypes = []
        lib.flash_attention_tile.restype = ctypes.c_int
        lib.flash_attention_tiles.argtypes = [p, p]
        lib.flash_attention_tiles.restype = None
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.library("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                               i, i, p, p]
        lib.flash_attention_bwd_dkv.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, p, p, p]
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.flash_attention_bwd_tile.argtypes = []
        lib.flash_attention_bwd_tile.restype = ctypes.c_int
        lib._typed = True
    return lib


def kernel_tile() -> int:
    """Query rows (and keys) per tile of the forward kernel (``TILE``), as
    the built library reports it: L must be a multiple of it."""
    return _lib().flash_attention_tile()


def kernel_tiles() -> tuple[int, int]:
    """(block_q, block_k) of the forward kernel (``TILES``), as the built
    library reports them: the twin run with these blocks rounds p against
    the same running maxima as the kernel."""
    bq, bk = ctypes.c_int(), ctypes.c_int()
    _lib().flash_attention_tiles(ctypes.byref(bq), ctypes.byref(bk))
    return bq.value, bk.value


def bwd_kernel_tile() -> int:
    """Query rows, and keys, per tile of the backward kernels: the
    backward twin's blocks for a like-for-like comparison."""
    return _bwd_lib().flash_attention_bwd_tile()


def _check(q, k, v, mask, num_heads: int, tile: int, **more) -> None:
    """Raise unless q, k, v (and the bf16 ``more``) are contiguous bf16
    [BH, L, D] with D in (32, 64, 128) and L a multiple of ``tile``, and the
    mask a contiguous int32 [BH / num_heads, L]."""
    if q.dim() != 3:
        raise ValueError("q, k, v must be [BH, L, D]")
    bh, L, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}, expected bfloat16")
        if tuple(t.shape) != (bh, L, d):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{(bh, L, d)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mask.dtype != torch.int32 or not mask.is_contiguous():
        raise TypeError("mask must be a contiguous int32 tensor")
    if num_heads < 1 or bh % num_heads or tuple(mask.shape) != (bh // num_heads, L):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not fit "
                         f"BH={bh}, num_heads={num_heads}, L={L}")
    if d not in (32, 64, 128):
        raise ValueError(f"head dim {d} not in (32, 64, 128)")
    if L % tile:
        raise ValueError(f"L={L} must be a multiple of the kernel tile {tile}")


def _launch(q, k, v, mask, num_heads: int, causal: bool, with_lse: bool):
    lib = _lib()
    _check(q, k, v, mask, num_heads, kernel_tile())
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:   # TMA reads from 16-byte aligned addresses
            raise ValueError(f"{name} must start on a 16-byte boundary")
    bh, L, d = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((bh, L, 1), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), bh,
            num_heads, L, d, int(causal), o.data_ptr(),
            None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    return o, lse


def _launch_bwd(kind: str, q, k, v, mask, do, lse, delta, num_heads: int,
                causal: bool, outs):
    lib = _bwd_lib()
    _check(q, k, v, mask, num_heads, lib.flash_attention_bwd_tile(), do=do)
    bh, L, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (bh, L, 1)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{(bh, L, 1)}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"flash_attention_bwd_{kind}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), bh, num_heads,
            L, d, int(causal), *(t.data_ptr() for t in outs), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_{kind} launch failed: "
                           f"CUDA error {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, num_heads: int,
                        causal: bool = False, block_q: int = 256,
                        block_k: int = 256):
    """[BH, L, D] q, k, v and a [B, L] key mask → (o [BH, L, D],
    lse [BH, L, 1] float32). ``block_q``/``block_k`` set the plain twin's
    blocks; the kernel uses its own (``TILES``)."""
    if on_cpu(q, k, v, mask):
        return flash_attention_plain(q, k, v, mask, num_heads, causal,
                                     block_q, block_k)
    out = _launch(q, k, v, mask, num_heads, causal, with_lse=True)
    flash_attention_fwd.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int, causal: bool = False,
                    block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """``flash_attention_fwd`` without the log-sum-exp: → o [BH, L, D]."""
    if on_cpu(q, k, v, mask):
        return flash_attention_plain(q, k, v, mask, num_heads, causal,
                                     block_q, block_k)[0]
    out = _launch(q, k, v, mask, num_heads, causal, with_lse=False)[0]
    flash_attention.launches += 1
    return out


def flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, num_heads: int,
                           causal: bool = False, block_q: int = 256,
                           block_k: int = 256) -> torch.Tensor:
    """dQ [BH, L, D] from q, k, v, the key mask, dO, the forward's lse and
    delta ([BH, L, 1] float32). ``block_q``/``block_k`` set the twin's
    blocks; the kernel uses its own 64 tile."""
    if on_cpu(q, k, v, mask, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta,
                                            num_heads, causal, block_q,
                                            block_k)
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, mask, do, lse, delta, num_heads, causal, (dq,))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, num_heads: int,
                            causal: bool = False, block_q: int = 256,
                            block_k: int = 256):
    """(dK, dV) [BH, L, D], from the same inputs as ``flash_attention_bwd_dq``."""
    if on_cpu(q, k, v, mask, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta,
                                             num_heads, causal, block_q,
                                             block_k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, mask, do, lse, delta, num_heads, causal,
                (dk, dv))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class FlashAttentionTrainable(torch.autograd.Function):
    """Differentiable flash attention with the contract of
    ``flash_attention_trainable``: ``apply(q, k, v, mask, num_heads, causal,
    block_q, block_k)`` → o [BH, L, D]. The forward saves q, k, v, the
    mask, o and the log-sum-exp; the backward returns dq, dk, dv (None for
    the mask and the other arguments). Kernels on CUDA tensors in both
    directions, the twins on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads: int, causal: bool = False,
                block_q: int = 256, block_k: int = 256):
        o, lse = flash_attention_fwd(q, k, v, mask, num_heads, causal,
                                     block_q, block_k)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.args = (num_heads, causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = bwd_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, *ctx.args)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: torch.Tensor,
                              num_heads: int, causal: bool = False,
                              block_q: int = 256,
                              block_k: int = 256) -> torch.Tensor:
    """``flash_attention`` with a blockwise backward (``FlashAttentionTrainable``);
    the mask is not differentiated."""
    return FlashAttentionTrainable.apply(
        q, k, v, mask.to(torch.int32).contiguous(), num_heads, causal,
        block_q, block_k)


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: torch.Tensor, causal: bool = False,
                         block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Model adapter: q, k, v [B, L, H, Dh] (GQA already expanded) and
    attention_mask [B, L] → [B, L, H, Dh], differentiable in q, k and v
    (``flash_attention_trainable``, as the TPU adapter calls)."""
    b, l, h, dh = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, l, dh).contiguous()

    out = flash_attention_trainable(fold(q), fold(k), fold(v), attention_mask,
                                    h, causal, block_q, block_k)
    return out.reshape(b, h, l, dh).permute(0, 2, 1, 3)


def total_launches() -> int:
    """Launches of the forward kernel through either of its wrappers."""
    return flash_attention.launches + flash_attention_fwd.launches


def reset_launches() -> None:
    """Set the forward's and both backward kernels' counts to 0."""
    for fn in (flash_attention, flash_attention_fwd, flash_attention_bwd_dq,
               flash_attention_bwd_dkv):
        fn.launches = 0


reset_launches()
