"""Fine-tune the bi-encoder on domain (query, document) pairs (port of
``cmw_rag_tpu/scripts/train_embedder.py``).

Contrastive (InfoNCE) adaptation of an embedding spec of the port's
registry (``config.py``), checkpointed as an npz in the JAX package's layout,
which both packages' embedders load (``TorchEmbedder(checkpoint=...)``).

    python -m cmw_rag_tpu_torch.scripts.train_embedder --dataset ds.json \\
        --model qwen3-embedding-0.6b --use-flash --max-tokens 1024 \\
        --out ckpt.npz [--epochs 4] [--batch-size 8] [--lr 1e-4] \\
        [--warmup-cosine] [--fp32] [--init warm.npz] [--device cuda]

``--dataset`` is the eval dataset's shape ({queries: [{query, judgments}],
corpus: [{kb_id, title, content}]}): each query pairs with its best-judged
document. ``--use-flash`` routes qwen3 attention through the flash kernels,
forward and backward (``--max-tokens`` a multiple of 64 on a card).
``--warmup-cosine``: linear warmup over the first 10% of the steps, then
cosine decay to lr/100 (``warmup_cosine_decay_schedule``, equal to optax's).

Not ported yet, each exits with code 2: ``--generated`` and ``--chunk-docs``
(their wiring onto the ported ``eval/corpus_gen.py`` and
``ingest/chunker.py``: ``ROADMAP.md`` Queue 1 item 7), ``--corpus``
(``DocumentProcessor``: item 5), ``--mesh`` (item 9).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

#: flags whose modules are not ported yet, and the ROADMAP item that ports them
NOT_PORTED = {
    "generated": "generate_training_pairs wired in (ROADMAP.md Queue 1 "
                 "item 7)",
    "chunk_docs": "split_text_with_context wired in (ROADMAP.md Queue 1 "
                  "item 7)",
    "corpus": "ingest/documents.py DocumentProcessor (ROADMAP.md Queue 1 "
              "item 5)",
    "mesh": "the multi-device trainer (ROADMAP.md Queue 1 item 9)",
}


def pairs_from_dataset(dataset: dict) -> list[tuple[str, str]]:
    by_id = {c["kb_id"]: c for c in dataset["corpus"]}
    pairs = []
    for q in dataset["queries"]:
        if not q.get("judgments"):
            continue
        best = max(q["judgments"].items(), key=lambda kv: kv[1])[0]
        doc = by_id.get(best)
        if doc:
            pairs.append((q["query"], doc["content"]))
    return pairs


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0):
    """``optax.warmup_cosine_decay_schedule``: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps`` (warmup included), held there."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--corpus", default=None, help="not ported yet")
    ap.add_argument("--generated", action="store_true", help="not ported yet")
    ap.add_argument("--chunk-docs", type=int, default=0, help="not ported yet")
    ap.add_argument("--mesh", action="store_true", help="not ported yet")
    ap.add_argument("--init", default=None,
                    help="warm-start checkpoint (npz) to fine-tune from")
    ap.add_argument("--out", default="embedder_ckpt.npz")
    ap.add_argument("--model", default=None, help="registry embedding slug")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup-cosine", action="store_true",
                    help="linear warmup (10%%) then cosine decay to lr/100")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 weights (better for small from-scratch towers)")
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--use-flash", action="store_true",
                    help="route qwen3 attention through the flash kernels, "
                         "forward and backward")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag):
            print(f"--{flag.replace('_', '-')} needs {what}, not ported yet",
                  file=sys.stderr)
            return 2
    if not args.dataset:
        print("need --dataset", file=sys.stderr)
        return 2
    with open(args.dataset, encoding="utf-8") as f:
        pairs = pairs_from_dataset(json.load(f))
    if len(pairs) < args.batch_size:
        print(f"only {len(pairs)} pairs; need >= batch size", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from cmw_rag_tpu_torch.config import Settings, get_embedding_model
    from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
    from cmw_rag_tpu_torch.models.t5_encoder import T5EncoderConfig
    from cmw_rag_tpu_torch.tokenizer import get_tokenizer
    from cmw_rag_tpu_torch.training import ContrastiveTrainer

    spec = get_embedding_model(args.model or Settings().embedding_model)
    tokenizer = get_tokenizer()
    vocab = -(-max(spec.vocab_size, tokenizer.n_vocab) // 128) * 128
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if spec.arch == "qwen3":
        cfg = Qwen3Config(
            vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
            num_layers=spec.num_layers, num_heads=spec.num_heads,
            num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
            dtype=dtype)
    else:
        cfg = T5EncoderConfig(
            vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
            num_layers=spec.num_layers, num_heads=spec.num_heads, dtype=dtype)
    lr = args.lr
    if args.warmup_cosine:
        total = max(1, len(pairs) // args.batch_size) * args.epochs
        lr = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=args.lr,
            warmup_steps=max(1, total // 10), decay_steps=total,
            end_value=args.lr / 100)
    trainer = ContrastiveTrainer(
        cfg, tokenizer=tokenizer, learning_rate=lr,
        max_tokens=args.max_tokens, query_prefix=spec.query_prefix,
        document_prefix=spec.document_prefix, pooling=spec.pooling,
        arch=spec.arch, use_flash=args.use_flash, device=args.device)
    if args.init:
        trainer.restore(args.init)
        print(f"warm-started from {args.init}")
    print(f"training {spec.slug} on {len(pairs)} pairs, {args.epochs} epochs "
          f"on {trainer.device}")
    losses = trainer.train(pairs, batch_size=args.batch_size,
                           epochs=args.epochs, log_every=100)
    last = losses[-max(1, len(losses) // args.epochs):]
    print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f} "
          f"(mean last epoch {np.mean(last):.4f})")
    trainer.save(args.out)
    print(f"checkpoint saved: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
