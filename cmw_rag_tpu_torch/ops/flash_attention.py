"""Flash attention forward: a hand-written CUDA kernel and its plain twin
(port of ``cmw_rag_tpu/ops/flash_attention.py:92 flash_attention``,
``:306 _fa_forward`` and the model adapter ``:443 flash_attention_bhld``).

Semantics, shared by every function here and by the TPU kernels they
replace: q, k, v are [BH, L, D] with BH = B * num_heads; scores are
``(q . k) / sqrt(D)`` in float32; a key whose ``mask[b, key] <= 0`` (batch
row ``b = bh // num_heads``) and, when causal, a key after the query get
-1e30; softmax runs online over key blocks (running max ``m``, running sum
``l``, float32 accumulator), with the probabilities rounded to v's dtype
before the value product; causal key blocks wholly above the diagonal are
skipped. ``o = acc / max(l, 1e-30)`` in q's dtype, and the per-row
log-sum-exp is ``m + log(max(l, 1e-30))`` in float32, [BH, L, 1].

- ``flash_attention``, ``flash_attention_fwd`` and ``flash_attention_bhld``
  are the wrappers the models call. On CUDA tensors they launch
  ``csrc/flash_attention.cu`` (bf16, D in {32, 64, 128}, L a multiple of its
  64-row tile), each adding one to its own ``launches`` count per launch
  (``total_launches()`` sums the three); on CPU tensors they run the plain
  twin. Wrong device, dtype, shape or contiguity raises: there is no
  fallback.
- ``flash_attention_plain`` is the plain twin: the TPU kernel's arithmetic
  over blocks of ``block_q`` queries and ``block_k`` keys.
"""

from __future__ import annotations

import ctypes

import torch

from cmw_rag_tpu_torch.device import on_cpu
from cmw_rag_tpu_torch.ops import cuda_build

NEG_INF = -1e30


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


# ------------------------------------------------------------------ kernel


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_tile.argtypes = []
        lib.flash_attention_tile.restype = ctypes.c_int
        lib._typed = True
    return lib


def kernel_tile() -> int:
    """Query rows, and keys, per tile of the kernel: the twin run with
    ``block_q = block_k = kernel_tile()`` rounds p against the same running
    maxima as the kernel."""
    return _lib().flash_attention_tile()


def _launch(q, k, v, mask, num_heads: int, causal: bool, with_lse: bool):
    if q.dim() != 3:
        raise ValueError("q, k, v must be [BH, L, D]")
    bh, L, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    lib = _lib()
    tile = kernel_tile()
    if L % tile:
        raise ValueError(f"L={L} must be a multiple of the kernel tile {tile}")
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, num_heads: int,
                        causal: bool = False, block_q: int = 256,
                        block_k: int = 256):
    """[BH, L, D] q, k, v and a [B, L] key mask → (o [BH, L, D],
    lse [BH, L, 1] float32). ``block_q``/``block_k`` set the plain twin's
    blocks; the kernel uses its own 64-row tile."""
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


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: torch.Tensor, causal: bool = False,
                         block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """Model adapter: q, k, v [B, L, H, Dh] (GQA already expanded) and
    attention_mask [B, L] → [B, L, H, Dh]."""
    b, l, h, dh = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, l, dh).contiguous()

    qf, kf, vf = fold(q), fold(k), fold(v)
    mask = attention_mask.to(torch.int32).contiguous()
    if on_cpu(qf, kf, vf, mask):
        out = flash_attention_plain(qf, kf, vf, mask, h, causal, block_q,
                                    block_k)[0]
    else:
        # the trainable forward, as the TPU adapter calls: it writes the LSE
        out = _launch(qf, kf, vf, mask, h, causal, with_lse=True)[0]
        flash_attention_bhld.launches += 1
    return out.reshape(b, h, l, dh).permute(0, 2, 1, 3)


def total_launches() -> int:
    """Launches of the kernel through any of its three wrappers."""
    return (flash_attention.launches + flash_attention_fwd.launches
            + flash_attention_bhld.launches)


def reset_launches() -> None:
    flash_attention.launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_bhld.launches = 0


reset_launches()
