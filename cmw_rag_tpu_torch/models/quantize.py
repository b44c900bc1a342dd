"""Weight-only int8 quantization for the decode path
(port of ``cmw_rag_tpu/models/quantize.py``).

Decode streams every weight byte once a step, so per-output-channel int8
halves the step's weight bytes. The stored tree keeps ONE copy of each
weight (int8 and scales); prefill dequantizes a layer at a time back to the
compute dtype and reuses the full-precision layer math. The tree is bit for
bit the JAX package's from the same weights (both round half to even).
"""

from __future__ import annotations

import torch

from cmw_rag_tpu_torch.ops.int8_matmul import quantize_weight

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_qwen3_params(params, cfg):
    """Parameter tree → int8 tree. The per-layer matmuls are fused before
    quantization, one ``wqkv`` [D, (Hq + 2 Hkv) Dh] and one ``w_gateup``
    [D, 2 d_ff] (column scales commute with concatenation, so fusion is
    exact). Norm scales and the embedding table stay as they are; the LM
    head is quantized on its own, its vocabulary padded with zero columns to
    a multiple of 128 (consumers slice the logits back to
    ``cfg.vocab_size``)."""
    out = {"embed": params["embed"], "layers": []}
    for layer in params["layers"]:
        ql = {k: v for k, v in layer.items() if k not in _MATMUL_KEYS}
        ql["wqkv_q"], ql["wqkv_s"] = quantize_weight(
            torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=1))
        ql["wo_q"], ql["wo_s"] = quantize_weight(layer["wo"])
        ql["w_gateup_q"], ql["w_gateup_s"] = quantize_weight(
            torch.cat([layer["w_gate"], layer["w_up"]], dim=1))
        ql["w_down_q"], ql["w_down_s"] = quantize_weight(layer["w_down"])
        out["layers"].append(ql)
    out["final_norm"] = params["final_norm"]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    v = head.shape[1]
    vpad = -(-v // 128) * 128
    if vpad != v:
        head = torch.nn.functional.pad(head, (0, vpad - v))
    out["head_q"], out["head_s"] = quantize_weight(head)
    return out


def dequantize_layer(qlayer, dtype, cfg):
    """int8 layer dict → full-precision layer dict with the ORIGINAL
    (unfused) names, for the prefill's reuse of the full-precision math."""
    def deq(name):
        return (qlayer[name + "_q"].float()
                * qlayer[name + "_s"][None, :]).to(dtype)

    out = {k: v for k, v in qlayer.items()
           if not (k.endswith("_q") or k.endswith("_s"))}
    hq, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.hd
    wqkv = deq("wqkv")
    out["wq"] = wqkv[:, : hq * dh]
    out["wk"] = wqkv[:, hq * dh:(hq + hkv) * dh]
    out["wv"] = wqkv[:, (hq + hkv) * dh:]
    out["wo"] = deq("wo")
    gateup = deq("w_gateup")
    out["w_gate"] = gateup[:, : cfg.d_ff]
    out["w_up"] = gateup[:, cfg.d_ff:]
    out["w_down"] = deq("w_down")
    return out
