"""Contrastive fine-tuning of the bi-encoder on one device (port of
``cmw_rag_tpu/training/contrastive.py``).

The FRIDA-class T5 encoder (``arch="t5"``) or the Qwen3-Embedding family
(``arch="qwen3"``, last-token pooling) trains with symmetric InfoNCE over
in-batch negatives, queries and documents through the same tower:
``loss = (CE(q.d^T / tau, diag) + CE(d.q^T / tau, diag)) / 2``. With
``arch="qwen3", use_flash=True`` attention runs through the flash kernels in
both directions (``ops/flash_attention.FlashAttentionTrainable``: the
forward and the dQ and dK/dV kernels on a card, their twins on the CPU), the
long-sequence fine-tuning path.

The optimizer is ``torch.optim.AdamW`` over the parameter tree's leaves in
JAX tree order, with ``optax.adamw``'s defaults passed explicitly (b1 0.9,
b2 0.999, eps 1e-8 and weight decay 1e-4 on every leaf; torch's own default
decay is 1e-2). A leaf that gets no gradient gets a zero one, so that it
decays and its moments move as optax's would. ``learning_rate`` may be a
callable ``step -> lr`` (an optax-style schedule), evaluated at the update
count from 0 and written into the optimizer before each update.

Checkpoints: ``save``/``restore`` write and read the npz layout of the JAX
package (``models/weights.py``), so a checkpoint moves between the packages
either way; ``save_state``/``restore_state`` stand in for
``save_orbax``/``restore_orbax`` (orbax is a JAX library): params and the
AdamW state with ``torch.save`` in a directory.

Not ported: the mesh (data- and tensor-parallel sharding) and the loss's
all-gather over a mesh axis raise, ``ROADMAP.md`` Queue 1 item 9.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.models.pooling import pool_hidden
from cmw_rag_tpu_torch.models.t5_encoder import (
    init_t5_encoder,
    t5_encode,
    t5_layout,
)
from cmw_rag_tpu_torch.models.weights import (
    load_params_npz,
    save_params_npz,
    tree_leaves,
)

MESH_ITEM = "ROADMAP.md Queue 1 item 9 (multi-device)"
#: ``optax.adamw``'s defaults (optax 0.2.6), which torch's AdamW does not share
ADAMW_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}
STATE_FILE = "state.pt"


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                  temperature: float = 0.05,
                  axis_name: str | None = None) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives; q_emb, d_emb [B, D] unit
    vectors → a float32 scalar."""
    if axis_name is not None:
        raise NotImplementedError(
            f"the loss over a mesh axis is not ported: {MESH_ITEM}")
    q, d = q_emb.float(), d_emb.float()
    labels = torch.arange(q.shape[0], device=q.device)
    loss_q = F.cross_entropy(q @ d.T / temperature, labels)
    loss_d = F.cross_entropy(d @ q.T / temperature, labels)
    return (loss_q + loss_d) / 2


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (AdamW's ``step``, a CPU tensor: no
    device sync)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            return 0 if step is None else int(step)
    return 0


def make_train_step(cfg, optimizer: torch.optim.Optimizer,
                    pooling: str = "cls", temperature: float = 0.05,
                    axis_name: str | None = None,
                    encode_fn: Callable | None = None,
                    learning_rate=None) -> Callable:
    """Returns ``train_step(params, batch) → loss``, a device scalar (no host
    sync). ``params`` is the tree whose leaves ``optimizer`` holds, updated
    in place; ``batch`` = dict(q_ids, q_mask, d_ids, d_mask) of [B, L] int
    tensors on the params' device. ``encode_fn(params, cfg, ids, mask) →
    hidden`` defaults to the T5 encoder. A callable ``learning_rate`` is
    evaluated at the update count and set on every parameter group before
    the update."""
    if axis_name is not None:
        raise NotImplementedError(
            f"the data-parallel step is not ported: {MESH_ITEM}")
    encode = encode_fn or t5_encode

    def loss_fn(params, batch):
        q_h = encode(params, cfg, batch["q_ids"], batch["q_mask"])
        d_h = encode(params, cfg, batch["d_ids"], batch["d_mask"])
        q = pool_hidden(q_h, batch["q_mask"], pooling, normalize=True)
        d = pool_hidden(d_h, batch["d_mask"], pooling, normalize=True)
        return info_nce_loss(q, d, temperature)

    def train_step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        for p in tree_leaves(params):
            if p.grad is None:  # optax updates it with a zero gradient
                p.grad = torch.zeros_like(p)
        if callable(learning_rate):
            lr = float(learning_rate(update_count(optimizer)))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        return loss.detach()

    train_step.loss_fn = loss_fn
    return train_step


class ContrastiveTrainer:
    """Host-facing trainer: tokenization, the step, npz checkpoints
    (``save``/``restore``) and full state (``save_state``/``restore_state``)."""

    def __init__(
        self,
        cfg,
        tokenizer=None,
        mesh=None,
        learning_rate=1e-5,
        temperature: float = 0.05,
        max_tokens: int = 256,
        seed: int = 0,
        query_prefix: str = "search_query: ",
        document_prefix: str = "search_document: ",
        pooling: str = "cls",
        arch: str = "t5",
        use_flash: bool = False,
        flash_block: int = 256,
        device: str | torch.device = "cuda",
    ):
        """``arch="qwen3"`` trains the Qwen3-Embedding family (pass
        ``pooling="last_token"``); ``use_flash=True`` routes its attention
        through the flash kernels, forward and backward (on the CPU their
        twins, in blocks of ``flash_block``; the sequence length must be a
        multiple of it there, and of the kernels' 64 tile on a card).
        Random init draws from a ``torch.Generator`` seeded with ``seed``;
        ``device`` is resolved by ``resolve_device`` (no fallback)."""
        if mesh is not None:
            raise NotImplementedError(
                f"the sharded trainer is not ported: {MESH_ITEM}")
        self.device = resolve_device(device)
        if tokenizer is None:
            from cmw_rag_tpu_torch.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.max_tokens = max_tokens
        self.query_prefix = query_prefix
        self.document_prefix = document_prefix
        if arch == "qwen3":
            from cmw_rag_tpu_torch.models.qwen3 import (
                init_qwen3,
                qwen3_hidden_states,
                qwen3_layout,
            )

            init_fn, self._layout_fn = init_qwen3, qwen3_layout

            def encode_fn(params, cfg, ids, mask):
                return qwen3_hidden_states(params, cfg, ids, mask,
                                           use_flash=use_flash,
                                           flash_block=flash_block)
        else:
            init_fn, self._layout_fn, encode_fn = (init_t5_encoder, t5_layout,
                                                   None)
        self.params = init_fn(torch.Generator().manual_seed(seed), cfg,
                              self.device)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
        self.optimizer = torch.optim.AdamW(tree_leaves(self.params),
                                           lr=float(lr0), **ADAMW_DEFAULTS)
        self._step = make_train_step(cfg, self.optimizer, pooling=pooling,
                                     temperature=temperature,
                                     encode_fn=encode_fn,
                                     learning_rate=learning_rate)

    # ------------------------------------------------------------- public
    def tokenize_pairs(self, queries, documents) -> dict[str, np.ndarray]:
        def enc(texts, prefix):
            rows = [self.tokenizer.encode(prefix + t)[: self.max_tokens] or [0]
                    for t in texts]
            ids = np.zeros((len(rows), self.max_tokens), np.int32)
            mask = np.zeros((len(rows), self.max_tokens), np.int32)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = 1
            return ids, mask

        q_ids, q_mask = enc(queries, self.query_prefix)
        d_ids, d_mask = enc(documents, self.document_prefix)
        return {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids,
                "d_mask": d_mask}

    def loss(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """The loss of ``batch`` at the current params, with the graph for
        ``backward`` (no update)."""
        return self._step.loss_fn(self.params, self._on_device(batch))

    def step(self, batch: dict[str, np.ndarray]) -> float:
        return float(self.step_async(batch))

    def step_async(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step; returns the loss as a device scalar (no host
        sync): loops keep these and convert once at the end (``train``)."""
        return self._step(self.params, self._on_device(batch))

    def train(self, pairs: list[tuple[str, str]], batch_size: int = 8,
              epochs: int = 1, log_every: int = 0) -> list[float]:
        """Tokenize every batch once (reused across epochs), step without
        syncing, fetch the losses once at the end (and every ``log_every``
        steps for progress)."""
        batches = []
        for i in range(0, len(pairs) - batch_size + 1, batch_size):
            chunk = pairs[i : i + batch_size]
            batches.append(self._on_device(self.tokenize_pairs(
                [q for q, _ in chunk], [d for _, d in chunk])))
        losses: list[torch.Tensor] = []
        n = 0
        for _ in range(epochs):
            for batch in batches:
                losses.append(self._step(self.params, batch))
                n += 1
                if log_every and n % log_every == 0:
                    print(f"  step {n}/{len(batches) * epochs} "
                          f"loss {float(losses[-1]):.4f}", flush=True)
        return torch.stack(losses).tolist() if losses else []

    def save(self, path) -> None:
        """The params as an npz in the JAX package's layout."""
        save_params_npz(self.params, path)

    def restore(self, path) -> None:
        """Load an npz (written here or by the JAX package) into the params
        in place; the optimizer state is kept, as JAX's ``restore`` keeps
        its ``opt_state``."""
        loaded = load_params_npz(self._layout_fn(self.cfg), path, self.device)
        self._copy_params(tree_leaves(loaded))

    def save_state(self, directory) -> None:
        """Params and the AdamW state (moments, update count, lr) with
        ``torch.save`` in ``directory``: the counterpart of JAX's
        ``save_orbax``."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        torch.save({"params": [p.detach() for p in tree_leaves(self.params)],
                    "optimizer": self.optimizer.state_dict()},
                   directory / STATE_FILE)

    def restore_state(self, directory) -> None:
        """Resume from ``save_state``: params and optimizer state."""
        state = torch.load(Path(directory) / STATE_FILE,
                           map_location=self.device, weights_only=True)
        self._copy_params(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])

    # ------------------------------------------------------------ internals
    def _on_device(self, batch: dict[str, np.ndarray]) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @torch.no_grad()
    def _copy_params(self, leaves: list) -> None:
        mine = tree_leaves(self.params)
        if len(leaves) != len(mine):
            raise ValueError(f"{len(leaves)} arrays, the model has {len(mine)}")
        for p, t in zip(mine, leaves):
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch: {tuple(t.shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
