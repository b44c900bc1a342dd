"""The port's contrastive training (cmw_rag_tpu_torch.training, the models'
gradients, ``save_params_npz`` and ``scripts/train_embedder.py``) against the
JAX package on the CPU, on the same inputs and weights.

Float32 tiny configs. Gradients of ``qwen3_hidden_states`` on the flash
route (JAX's Pallas kernels in interpret mode, the port's twins) to rtol
5e-3, atol 5e-4, the JAX package's flash-route tolerance
(``tests/test_flash_attention.py``); the T5 encoder's to rtol 1e-4 plus
1e-4 of each leaf's largest |element| (float32 sums in another order, which
cancel in a few elements: 2 of the embedding's 528,384 were 1.8e-5 apart);
``info_nce_loss`` and its gradient to 1e-6 and 1e-5. The trainers: weights
carried from JAX's trainer by its own npz checkpoint, batches tokenized
identically, the first-step loss within 1e-5; after 1 and 3 AdamW steps
every parameter within 1e-3 * lr of JAX's wherever JAX's first gradient is
exactly 0 or stands above float32 noise: above 1e-6 and above 1e-3 of its
leaf's largest |gradient|. Adam's first steps move a parameter by about lr
times the sign of its gradient, so its later steps follow the ratio of the
gradients, and float32 sums in another order leave ~1e-6 of a leaf's scale
in each (T5's embedding gradients reach 107 on this batch, and an element
of 3.3e-4 there came out 2.6e-4: a 0.016 lr step apart after 2 steps). The
warmup-cosine schedule within 1e-6 relative plus 1e-6 of its peak of
optax's at every step (optax computes in float32; a ramp from 1e-5 to 1e-3
rounds 1e-5 to 7.6e-6 relative there).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmw_rag_tpu.models import qwen3 as jqwen
from cmw_rag_tpu.models.common import load_params_npz as jax_load
from cmw_rag_tpu.models.common import save_params_npz as jax_save
from cmw_rag_tpu.models.pooling import pool_hidden as jax_pool
from cmw_rag_tpu.models.t5_encoder import T5EncoderConfig as JT5Config
from cmw_rag_tpu.models.t5_encoder import init_t5_encoder as jax_t5_init
from cmw_rag_tpu.models.t5_encoder import t5_encode as jax_t5_encode
from cmw_rag_tpu.scripts import train_embedder as JS
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu.training import contrastive as JC
from cmw_rag_tpu_torch.models import qwen3 as tqwen
from cmw_rag_tpu_torch.models.pooling import pool_hidden
from cmw_rag_tpu_torch.models.t5_encoder import T5EncoderConfig, t5_encode
from cmw_rag_tpu_torch.models.weights import (
    load_params_npz,
    params_from_jax,
    save_params_npz,
    tree_leaves,
)
from cmw_rag_tpu_torch.scripts import train_embedder as TS
from cmw_rag_tpu_torch.tokenizer import get_tokenizer
from cmw_rag_tpu_torch.training import contrastive as TC

TOK, JTOK = get_tokenizer(), jax_tokenizer()
VOCAB = -(-TOK.n_vocab // 128) * 128
T5_DIMS = dict(vocab_size=VOCAB, d_model=32, d_ff=64, num_layers=2,
               num_heads=2)
QWEN_DIMS = dict(vocab_size=VOCAB, d_model=32, d_ff=64, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=8)
LR = 1e-3
MAX_TOKENS, BLOCK = 64, 32
PAIRS = [
    ("как настроить резервное копирование", "Резервное копирование базы "
     "данных настраивается в разделе администрирования каждую ночь."),
    ("printer queue on windows", "Configure the printer queue: open the "
     "print server settings and add the device."),
    ("экспорт шаблона ошибка", "Ошибка при экспорте шаблона возникает, "
     "если у пользователя нет прав на запись."),
    ("webhook retries", "Webhooks are retried three times with exponential "
     "backoff before the delivery is marked failed."),
]
ARCHS = {
    "t5": dict(jcfg=JT5Config(dtype=jnp.float32, **T5_DIMS),
               tcfg=T5EncoderConfig(dtype=torch.float32, **T5_DIMS),
               kw=dict(pooling="mean", arch="t5")),
    "qwen3-flash": dict(jcfg=jqwen.Qwen3Config(dtype=jnp.float32, **QWEN_DIMS),
                        tcfg=tqwen.Qwen3Config(dtype=torch.float32,
                                               **QWEN_DIMS),
                        kw=dict(pooling="last_token", arch="qwen3",
                                use_flash=True, flash_block=BLOCK,
                                query_prefix="", document_prefix="")),
}


def _np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _ids_mask(seed, b=2, l=MAX_TOKENS):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, l // 2 + 5:] = 0
    return ids, mask


# ---------------------------------------------------------------- gradients


def test_qwen3_flash_route_gradients_match_jax():
    jcfg, tcfg = ARCHS["qwen3-flash"]["jcfg"], ARCHS["qwen3-flash"]["tcfg"]
    jp = jqwen.init_qwen3(jax.random.PRNGKey(1), jcfg)
    ids, mask = _ids_mask(2)
    w = np.random.default_rng(3).standard_normal(
        (2, MAX_TOKENS, 32)).astype(np.float32) * mask[..., None]

    def jloss(p):
        h = jqwen.qwen3_hidden_states(p, jcfg, jnp.asarray(ids),
                                      jnp.asarray(mask), use_flash=True,
                                      flash_block=BLOCK, flash_interpret=True)
        return jnp.sum(h * w)

    want = _np(jax.grad(jloss)(jp))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    h = tqwen.qwen3_hidden_states(tp, tcfg, torch.from_numpy(ids),
                                  torch.from_numpy(mask), use_flash=True,
                                  flash_block=BLOCK)
    got = torch.autograd.grad((h * torch.from_numpy(w)).sum(), leaves)
    assert len(got) == len(want)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=5e-3, atol=5e-4)
    # the plain route gives the same gradients (the model is differentiable
    # on both)
    plain = tqwen.qwen3_hidden_states(tp, tcfg, torch.from_numpy(ids),
                                      torch.from_numpy(mask))
    got_plain = torch.autograd.grad((plain * torch.from_numpy(w)).sum(),
                                    leaves)
    for g, ref in zip(got_plain, want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("pooling", ["cls", "mean", "last_token"])
def test_t5_encoder_and_pooling_gradients_match_jax(pooling):
    jcfg, tcfg = ARCHS["t5"]["jcfg"], ARCHS["t5"]["tcfg"]
    jp = jax_t5_init(jax.random.PRNGKey(4), jcfg)
    ids, mask = _ids_mask(5, l=16)
    w = np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)

    def jloss(p):
        h = jax_t5_encode(p, jcfg, jnp.asarray(ids), jnp.asarray(mask))
        return jnp.sum(jax_pool(h, jnp.asarray(mask), pooling) * w)

    want = _np(jax.grad(jloss)(jp))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    h = t5_encode(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    loss = (pool_hidden(h, torch.from_numpy(mask), pooling)
            * torch.from_numpy(w)).sum()
    for g, ref in zip(torch.autograd.grad(loss, leaves), want):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_t5_trains_after_inference_at_the_same_length():
    """The relative-position bucket table is cached per length; a table
    first built under ``torch.inference_mode`` (an embedder's forward)
    must still index the bias of a later training step at that length
    (autograd cannot save an inference tensor)."""
    from cmw_rag_tpu_torch.models import t5_encoder as T5

    tcfg = ARCHS["t5"]["tcfg"]
    tp = params_from_jax(jax.tree.map(np.asarray, jax_t5_init(
        jax.random.PRNGKey(4), ARCHS["t5"]["jcfg"])))
    ids, mask = (torch.from_numpy(a) for a in _ids_mask(5, l=40))
    T5._bucket_table.cache_clear()
    with torch.inference_mode():
        want = t5_encode(tp, tcfg, ids, mask)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    h = t5_encode(tp, tcfg, ids, mask)
    grads = torch.autograd.grad(h.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    torch.testing.assert_close(h.detach(), want, rtol=0, atol=0)


def test_info_nce_loss_and_gradient_match_jax():
    rng = np.random.default_rng(7)
    q, d = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jl, jg = jax.value_and_grad(JC.info_nce_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(d), 0.05)
    tq, td = (torch.from_numpy(x).requires_grad_() for x in (q, d))
    tl = TC.info_nce_loss(tq, td, 0.05)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)
    for g, ref in zip(torch.autograd.grad(tl, (tq, td)), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TC.info_nce_loss(tq, td, axis_name="data")


# ----------------------------------------------------------------- trainers


def _trainer_pair(arch, tmp_path, learning_rate=LR):
    a = ARCHS[arch]
    jkw = dict(a["kw"], flash_interpret=True) if a["kw"].get("use_flash") \
        else a["kw"]
    jt = JC.ContrastiveTrainer(a["jcfg"], tokenizer=JTOK,
                               learning_rate=learning_rate,
                               max_tokens=MAX_TOKENS, seed=0, **jkw)
    tt = TC.ContrastiveTrainer(a["tcfg"], tokenizer=TOK,
                               learning_rate=learning_rate,
                               max_tokens=MAX_TOKENS, seed=1, device="cpu",
                               **a["kw"])
    jt.save(str(tmp_path / "init.npz"))
    tt.restore(tmp_path / "init.npz")
    return jt, tt


def _jax_first_grads(jt, arch, batch):
    a = ARCHS[arch]
    jcfg, kw = a["jcfg"], a["kw"]
    if kw["arch"] == "qwen3":
        def encode(p, ids, mask):
            return jqwen.qwen3_hidden_states(
                p, jcfg, ids, mask, use_flash=True, flash_block=BLOCK,
                flash_interpret=True)
    else:
        def encode(p, ids, mask):
            return jax_t5_encode(p, jcfg, ids, mask)

    def loss(p):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        q = jax_pool(encode(p, b["q_ids"], b["q_mask"]), b["q_mask"],
                     kw["pooling"])
        d = jax_pool(encode(p, b["d_ids"], b["d_mask"]), b["d_mask"],
                     kw["pooling"])
        return JC.info_nce_loss(q, d, 0.05)

    return _np(jax.grad(loss)(jt.params))


def _assert_params_close(tt, jt, grads, what):
    for t, j, g in zip(tree_leaves(tt.params), _np(jt.params), grads):
        floor = max(1e-6, 1e-3 * np.abs(g).max())
        fixed = (np.abs(g) > floor) | (g == 0)
        err = np.abs(t.detach().numpy() - j)[fixed]
        assert err.size == 0 or err.max() <= 1e-3 * LR, (what, err.max())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_trainer_matches_jax_loss_and_updates(arch, tmp_path):
    jt, tt = _trainer_pair(arch, tmp_path)
    assert tt.optimizer.defaults["weight_decay"] == 1e-4
    assert tt.optimizer.defaults["betas"] == (0.9, 0.999)
    qs, ds = [p[0] for p in PAIRS], [p[1] for p in PAIRS]
    batch = tt.tokenize_pairs(qs, ds)
    for k, v in jt.tokenize_pairs(qs, ds).items():
        np.testing.assert_array_equal(batch[k], v)
    grads = _jax_first_grads(jt, arch, batch)
    for t, j in zip(tree_leaves(tt.params), _np(jt.params)):
        np.testing.assert_array_equal(t.detach().numpy(), j)
    loss_t = tt.step_async(batch)
    assert isinstance(loss_t, torch.Tensor) and loss_t.dim() == 0
    loss_j = jt.step(batch)
    assert abs(float(loss_t) - loss_j) <= 1e-5
    _assert_params_close(tt, jt, grads, "after 1 step")
    for _ in range(2):
        assert abs(tt.step(batch) - jt.step(batch)) <= 1e-5
    _assert_params_close(tt, jt, grads, "after 3 steps")


def test_train_tokenizes_once_and_returns_every_loss(tmp_path):
    tt = TC.ContrastiveTrainer(ARCHS["t5"]["tcfg"], tokenizer=TOK,
                               learning_rate=LR, max_tokens=32,
                               device="cpu", pooling="mean")
    losses = tt.train(PAIRS * 2, batch_size=4, epochs=2)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_save_state_resumes_the_next_step(tmp_path):
    sched = TS.warmup_cosine_decay_schedule(0.0, LR, 2, 10, LR / 100)
    kw = dict(tokenizer=TOK, learning_rate=sched, max_tokens=32,
              device="cpu", pooling="mean")
    a = TC.ContrastiveTrainer(ARCHS["t5"]["tcfg"], **kw)
    batch = a.tokenize_pairs([p[0] for p in PAIRS], [p[1] for p in PAIRS])
    for _ in range(3):
        a.step(batch)
    a.save_state(tmp_path / "state")
    want = a.step(batch)
    b = TC.ContrastiveTrainer(ARCHS["t5"]["tcfg"], seed=5, **kw)
    b.restore_state(tmp_path / "state")
    assert TC.update_count(b.optimizer) == 3
    assert abs(b.step(batch) - want) <= 1e-5
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=0, atol=1e-7)


def test_trainer_refuses_a_mesh_and_the_card_without_one():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TC.ContrastiveTrainer(ARCHS["t5"]["tcfg"], tokenizer=TOK,
                              mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TC.ContrastiveTrainer(ARCHS["t5"]["tcfg"], tokenizer=TOK)


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_checkpoints_cross_both_ways(dtype, tmp_path):
    jcfg = jqwen.Qwen3Config(dtype=getattr(jnp, dtype), **QWEN_DIMS)
    tcfg = tqwen.Qwen3Config(dtype=getattr(torch, dtype), **QWEN_DIMS)
    jp = jqwen.init_qwen3(jax.random.PRNGKey(8), jcfg)
    jax_save(jp, str(tmp_path / "jax.npz"))
    got = load_params_npz(tqwen.qwen3_layout(tcfg), tmp_path / "jax.npz")
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mine = tqwen.init_qwen3(torch.Generator().manual_seed(9), tcfg)
    save_params_npz(mine, tmp_path / "port.npz")
    with np.load(tmp_path / "port.npz") as data:
        assert data["arr_0"].dtype == np.float32
    back = jax_load(jp, str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(mine)):
        assert a.dtype == getattr(jnp, dtype) or a.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


# ------------------------------------------------------------------ script


@pytest.mark.parametrize("args", [(0.0, 1e-4, 5, 50, 1e-6),
                                  (0.0, 3e-4, 1, 7, 3e-6),
                                  (1e-5, 1e-3, 10, 40, 0.0)])
def test_warmup_cosine_matches_optax_at_every_step(args):
    mine = TS.warmup_cosine_decay_schedule(*args)
    ref = optax.warmup_cosine_decay_schedule(*args)
    for count in range(args[3] + 10):
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-6 * args[1])


def test_pairs_from_dataset_and_refused_flags(tmp_path, capsys):
    ds = {"corpus": [{"kb_id": str(i), "title": "t", "content": d}
                     for i, (_, d) in enumerate(PAIRS)],
          "queries": [{"query": q, "judgments": {str(i): 3, "9": 1}}
                      for i, (q, _) in enumerate(PAIRS)]
          + [{"query": "no judgments", "judgments": {}}]}
    assert TS.pairs_from_dataset(ds) == JS.pairs_from_dataset(ds) == PAIRS
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(ds), encoding="utf-8")
    for flag, item in (("--generated", "item 7"), ("--chunk-docs=64", "item 7"),
                       ("--corpus=docs", "item 5"), ("--mesh", "item 9")):
        assert TS.main(["--dataset", str(path), flag]) == 2
        assert item in capsys.readouterr().err
    assert TS.main([]) == 2


def test_train_embedder_runs_qwen3_flash_on_the_cpu(tmp_path):
    ds = {"corpus": [{"kb_id": str(i), "title": "t", "content": d}
                     for i, (_, d) in enumerate(PAIRS)],
          "queries": [{"query": q, "judgments": {str(i): 3}}
                      for i, (q, _) in enumerate(PAIRS)]}
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(ds), encoding="utf-8")
    out = tmp_path / "ckpt.npz"
    assert TS.main(["--dataset", str(path), "--model", "qwen3-mini",
                    "--use-flash", "--max-tokens", "64", "--batch-size", "2",
                    "--epochs", "1", "--fp32", "--warmup-cosine",
                    "--device", "cpu", "--out", str(out)]) == 0
    spec = dict(vocab_size=VOCAB, d_model=256, d_ff=768, num_layers=4,
                num_heads=4, num_kv_heads=2, head_dim=64)
    like = jqwen.init_qwen3(jax.random.PRNGKey(0),
                            jqwen.Qwen3Config(dtype=jnp.float32, **spec))
    loaded = jax_load(like, str(out))  # the JAX package reads it
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(loaded))
