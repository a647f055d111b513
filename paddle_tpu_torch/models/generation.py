"""Paged prefill/decode over the KV block pool (port of the serving half of
``paddle_tpu/models/generation.py``).

``gpt_decode_state`` and ``llama_decode_state`` extract a model's weight
tree and its architecture plug (GPT: LayerNorm, learned positions, fused
qkv, GELU, tied head; Llama: RMSNorm, RoPE at absolute positions, GQA
against the un-repeated KV cache, SwiGLU, untied head); the builders return
plain functions over tensors that the serving engine calls once per
scheduler step:

* ``build_paged_prefill`` — dense causal pass over a length-bucketed prompt
  batch, K/V scattered blockwise into the pool, logits at each row's last
  prompt token;
* ``build_paged_decode`` — one packed decode step that gathers each row's
  context through its block table and attends densely (the plain path);
* ``build_paged_decode_kernel`` — the same step with the attention read done
  by the paged-attention kernel straight out of the pool.

Where the reference rebuilt the pools functionally (``kpool.at[...].set``),
these functions update ``kpool``/``vpool`` **in place** (``index_put_``) and
return the same tensors. Greedy rows take ``argmax``; sampled rows
(``temps > 0``) draw from an explicit ``torch.Generator`` (Gumbel-max), which
cannot reproduce JAX's bits — parity with the reference is pinned on greedy
rows only. Weight trees may be plain dicts of tensors or the lazy
dequantizing view of ``serving/int8.py`` (``take`` gathers int8 rows first).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layer.norm import layer_norm
from ..ops.kernels import int8_matmul, paged_attention_rows
from .llama import rope_angles, rotate_pairs


def _grouped_attention(q, kc, vc, live, rep):
    """Attention of q (B,T,H,D) against an UN-repeated KV cache
    (B,Tk,KV,D): GQA via a grouped einsum, the repeats never materialized.
    ``live`` broadcasts against the (B,KV,rep,T,Tk) scores."""
    B, T, H, D = q.shape
    KV = kc.shape[2]
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=q.dtype, device=q.device)
    qg = q.reshape(B, T, KV, rep, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc) * scale
    s = s.masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, vc)
    return o.reshape(B, T, H * D)


_ln = layer_norm


def _rows(params, key, idx):
    """``params[key][idx]``; a dequantizing view gathers the int8 rows first
    and dequantizes only those."""
    take = getattr(params, "take", None)
    return take(key, idx) if take is not None else params[key][idx]


def _head_mm(params, rows, key, transpose):
    """LM-head matmul; with an attached int8 head (``params["head_q"]``, see
    ``serving/int8.attach_int8_head``) the weight stays int8 through the
    fused dequant matmul kernel, otherwise the dense matmul."""
    hq = params.get("head_q")
    if hq is not None:
        return int8_matmul(rows, hq["q"], hq["scale"], transpose_w=transpose)
    w = params[key]
    return rows @ (w.T if transpose else w)


# ---------------------------------------------------------------------------
# GPT architecture plug
# ---------------------------------------------------------------------------

def _gpt_layer_weights(layer, device):
    a, m = layer.attn, layer.mlp

    def t(p):
        return p.detach().to(device)

    return {
        "ln1_w": t(layer.ln1.weight), "ln1_b": t(layer.ln1.bias),
        "qkv_w": t(a.qkv.weight), "qkv_b": t(a.qkv.bias),
        "proj_w": t(a.proj.weight), "proj_b": t(a.proj.bias),
        "ln2_w": t(layer.ln2.weight), "ln2_b": t(layer.ln2.bias),
        "up_w": t(m.up.weight), "up_b": t(m.up.bias),
        "down_w": t(m.down.weight), "down_b": t(m.down.bias),
    }


def _gpt_arch(H, D):
    def embed_prompt(params, ids, T0):
        wpe = _rows(params, "wpe", torch.arange(T0, device=ids.device))
        return _rows(params, "wte", ids) + wpe[None]

    def embed_rows(params, toks, pos):
        # packed decode: one token per row at per-row absolute positions —
        # toks (B,), pos (B,) -> (B, 1, H·D)
        return (_rows(params, "wte", toks) + _rows(params, "wpe", pos))[:, None]

    def head_rows(params, x, idx):
        # logits at each row's own position; the norm is per row, so picking
        # the rows first gives the reference's values
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return _head_mm(params, _ln(rows, params["lnf_w"], params["lnf_b"]),
                        "wte", True)

    def mlp_out(w, x):
        h2 = _ln(x, w["ln2_w"], w["ln2_b"])
        ff = F.gelu(h2 @ w["up_w"] + w["up_b"], approximate="tanh") \
            @ w["down_w"] + w["down_b"]
        return x + ff

    def qkv_rows(w, x, pos):
        # the projection half of block_rows: x (B,1,H·D) -> q, k_new, v_new
        # each (B,H,D); pos (the rows' positions) is unused: GPT's positions
        # entered with the embedding
        B = x.shape[0]
        h = _ln(x, w["ln1_w"], w["ln1_b"])
        qkv = (h @ w["qkv_w"] + w["qkv_b"]).reshape(B, 3, H, D)
        return qkv[:, 0], qkv[:, 1], qkv[:, 2]

    def attn_out_rows(w, x, o):
        # the post-attention half of block_rows: o (B,1,H·D) attention read
        return mlp_out(w, x + (o @ w["proj_w"] + w["proj_b"]))

    def block_rows(w, x, k_ctx, v_ctx, live, pos):
        # single-token decode against a GATHERED paged context (the step's
        # private copy): the fresh k/v overwrite the slot at pos in-context,
        # live (B,Tp) masks positions <= pos. The caller scatters
        # (k_new, v_new) back into the pool.
        rows = torch.arange(x.shape[0], device=x.device)
        q, k_new, v_new = qkv_rows(w, x, pos)
        k_ctx[rows, pos] = k_new
        v_ctx[rows, pos] = v_new
        o = _grouped_attention(q[:, None], k_ctx, v_ctx,
                               live[:, None, None, None, :], rep=1)
        return attn_out_rows(w, x, o), k_new, v_new

    def block(w, x):
        # dense causal pass over a prompt batch x (B,T,H·D)
        B, T = x.shape[0], x.shape[1]
        h = _ln(x, w["ln1_w"], w["ln1_b"])
        qkv = (h @ w["qkv_w"] + w["qkv_b"]).reshape(B, T, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        live = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        o = _grouped_attention(q, k, v, live[None, None, None], rep=1)
        return mlp_out(w, x + (o @ w["proj_w"] + w["proj_b"])), (k, v)

    def head(params, x):
        return _head_mm(params, _ln(x[:, -1], params["lnf_w"], params["lnf_b"]),
                        "wte", True)  # tied head

    return {"embed_prompt": embed_prompt, "embed_rows": embed_rows,
            "head_rows": head_rows, "block_rows": block_rows,
            "qkv_rows": qkv_rows, "attn_out_rows": attn_out_rows,
            "block": block, "head": head, "kv_heads": H, "head_dim": D}


def gpt_decode_state(model, device=None):
    """(arch_key, arch, params, max_positions) for a ``GPTForPretraining``;
    the weight tree is detached and placed on ``device`` (the model's own
    when None)."""
    gpt, cfg = model.gpt, model.config
    H = cfg.num_heads
    D = cfg.hidden_size // H
    wte = gpt.embeddings.word_embeddings.weight
    device = wte.device if device is None else device

    def t(p):
        return p.detach().to(device)

    params = {
        "wte": t(wte),
        "wpe": t(gpt.embeddings.position_embeddings.weight),
        "lnf_w": t(gpt.final_ln.weight), "lnf_b": t(gpt.final_ln.bias),
        "layers": [_gpt_layer_weights(l, device) for l in gpt.layers],
    }
    arch_key = ("gpt", H, D, len(params["layers"]))
    return arch_key, _gpt_arch(H, D), params, cfg.max_position_embeddings


# ---------------------------------------------------------------------------
# Llama architecture plug
# ---------------------------------------------------------------------------

def _llama_layer_weights(layer, device):
    a, m = layer.self_attn, layer.mlp

    def t(p):
        return p.detach().to(device)

    return {
        "ln1_w": t(layer.input_layernorm.weight),
        "q_w": t(a.q_proj.weight), "k_w": t(a.k_proj.weight),
        "v_w": t(a.v_proj.weight), "o_w": t(a.o_proj.weight),
        "ln2_w": t(layer.post_attention_layernorm.weight),
        "gate_w": t(m.gate_proj.weight), "up_w": t(m.up_proj.weight),
        "down_w": t(m.down_proj.weight),
    }


def _rms(x, w, eps):
    """The serving plug's RMS norm: the f32 rsqrt is cast to x's dtype
    BEFORE the product, which is then taken in x's dtype (the model's
    ``RMSNorm`` multiplies in f32 and casts after; the two round differently
    in bf16, and each is the reference's in its place)."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def _rotate(x, ang):
    """Interleaved-pair rotation with cos/sin cast to x's dtype before the
    products (the serving plug's rounding)."""
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    return rotate_pairs(x, cos, sin)


def _rope_at(x, pos0, theta):
    """Rotary embedding of x (B, T, H, D) at absolute positions
    pos0 + [0..T)."""
    T, D = x.shape[1], x.shape[-1]
    pos = pos0 + torch.arange(T, dtype=torch.float32, device=x.device)
    return _rotate(x, rope_angles(pos, D, theta)[None, :, None, :])


def _rope_rows(x, pos, theta):
    """Rotary embedding of ONE token per row at per-row absolute positions
    (packed decode): x (B, 1, H, D), pos (B,) int."""
    ang = rope_angles(pos.float(), x.shape[-1], theta)  # (B, D/2)
    return _rotate(x, ang[:, None, None, :])


def _llama_arch(H, KV, D, theta, eps):
    rep = H // KV

    def embed_prompt(params, ids, T0):
        return _rows(params, "wte", ids)

    def embed_rows(params, toks, pos):
        return _rows(params, "wte", toks)[:, None]

    def head_rows(params, x, idx):
        # the norm is per row, so picking the rows first gives the
        # reference's values
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return _head_mm(params, _rms(rows, params["lnf_w"], eps), "head_w",
                        False)

    def mlp_out(w, x):
        h2 = _rms(x, w["ln2_w"], eps)
        return x + (F.silu(h2 @ w["gate_w"]) * (h2 @ w["up_w"])) @ w["down_w"]

    def qkv_rows(w, x, pos):
        # the projection half of block_rows: RoPE at each row's own absolute
        # position, un-repeated KV heads: q (B,H,D), k_new/v_new (B,KV,D)
        B = x.shape[0]
        h = _rms(x, w["ln1_w"], eps)
        q = _rope_rows((h @ w["q_w"]).reshape(B, 1, H, D), pos, theta)
        k = _rope_rows((h @ w["k_w"]).reshape(B, 1, KV, D), pos, theta)
        v = (h @ w["v_w"]).reshape(B, 1, KV, D)
        return q[:, 0], k[:, 0], v[:, 0]

    def attn_out_rows(w, x, o):
        return mlp_out(w, x + o @ w["o_w"])

    def block_rows(w, x, k_ctx, v_ctx, live, pos):
        # see the GPT plug for the contract; GQA against the un-repeated
        # gathered cache
        rows = torch.arange(x.shape[0], device=x.device)
        q, k_new, v_new = qkv_rows(w, x, pos)
        k_ctx[rows, pos] = k_new
        v_ctx[rows, pos] = v_new
        o = _grouped_attention(q[:, None], k_ctx, v_ctx,
                               live[:, None, None, None, :], rep)
        return attn_out_rows(w, x, o), k_new, v_new

    def block(w, x):
        # dense causal pass over a prompt batch x (B,T,H·D), RoPE at
        # positions 0..T-1; returns the KV heads, never the repeats
        B, T = x.shape[0], x.shape[1]
        h = _rms(x, w["ln1_w"], eps)
        q = _rope_at((h @ w["q_w"]).reshape(B, T, H, D), 0.0, theta)
        k = _rope_at((h @ w["k_w"]).reshape(B, T, KV, D), 0.0, theta)
        v = (h @ w["v_w"]).reshape(B, T, KV, D)
        live = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        o = _grouped_attention(q, k, v, live[None, None, None], rep)
        return attn_out_rows(w, x, o), (k, v)

    def head(params, x):
        return _head_mm(params, _rms(x[:, -1], params["lnf_w"], eps),
                        "head_w", False)  # untied head, (h, V)

    return {"embed_prompt": embed_prompt, "embed_rows": embed_rows,
            "head_rows": head_rows, "block_rows": block_rows,
            "qkv_rows": qkv_rows, "attn_out_rows": attn_out_rows,
            "block": block, "head": head, "kv_heads": KV, "head_dim": D}


def llama_decode_state(model, device=None):
    """(arch_key, arch, params, max_positions) for a ``LlamaForCausalLM``;
    the weight tree is detached and placed on ``device`` (the model's own
    when None)."""
    lm, cfg = model.model, model.model.config
    H, KV = cfg.num_heads, cfg.kv_heads
    D = cfg.hidden_size // H
    wte = lm.embed_tokens.weight
    device = wte.device if device is None else device

    def t(p):
        return p.detach().to(device)

    params = {
        "wte": t(wte),
        "lnf_w": t(lm.norm.weight),
        "head_w": t(model.lm_head.weight),
        "layers": [_llama_layer_weights(l, device) for l in lm.layers],
    }
    theta, eps = float(cfg.rope_theta), float(cfg.rms_norm_eps)
    arch_key = ("llama", H, KV, D, len(params["layers"]), theta, eps)
    return (arch_key, _llama_arch(H, KV, D, theta, eps), params,
            cfg.max_position_embeddings)


# ---------------------------------------------------------------------------
# paged builders
# ---------------------------------------------------------------------------

def _sample(logits, temps, generator):
    """Greedy where ``temps == 0``, else a categorical draw at that
    temperature (Gumbel-max over ``generator``'s uniforms)."""
    greedy = logits.argmax(-1).to(torch.int32)
    scaled = (logits / torch.clamp(temps, min=1e-6)[:, None]).float()
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def build_paged_prefill(arch, B, T_bucket, block_size, max_blocks):
    """Prompt prefill over a length-bucketed batch, writing KV into the pool.

    ``prefill(params, ids, lens, tables, kpool, vpool)`` runs the dense
    causal forward over ``ids`` (B, T_bucket) — causality makes the K/V of
    every real position exact whatever padding follows — scatters each
    layer's K/V as ``T_bucket // block_size`` blocks at ``tables[:, :nb]``
    (rows shorter than the bucket point their tail entries at the trash
    block 0) IN PLACE, and returns ``(kpool, vpool, logits)`` with logits at
    each row's last prompt token (``lens - 1``)."""
    KV, D = arch["kv_heads"], arch["head_dim"]
    if T_bucket % block_size:
        raise ValueError(f"prefill bucket {T_bucket} must be a multiple of "
                         f"block_size {block_size}")
    nb = T_bucket // block_size
    if nb > max_blocks:
        raise ValueError("prefill bucket exceeds max sequence blocks")

    def prefill(params, ids, lens, tables, kpool, vpool):
        x = arch["embed_prompt"](params, ids.long(), T_bucket)
        tb = tables[:, :nb].long()
        for li, w in enumerate(params["layers"]):
            x, (k, v) = arch["block"](w, x)
            kpool[li][tb] = k.reshape(B, nb, block_size, KV, D)
            vpool[li][tb] = v.reshape(B, nb, block_size, KV, D)
        return kpool, vpool, arch["head_rows"](params, x, lens.long() - 1)

    return prefill


def _decode_step(logits_fn):
    def step(params, kpool, vpool, tables, pos, toks, temps, generator=None):
        logits = logits_fn(params, kpool, vpool, tables, pos, toks)
        return kpool, vpool, _sample(logits, temps, generator)

    step.logits = logits_fn  # the step before sampling (debug and tests)
    return step


def build_paged_decode(arch, B, block_size, max_blocks):
    """One packed continuous-batching decode step over the paged KV cache.

    ``step(params, kpool, vpool, tables, pos, toks, temps, generator)``
    feeds one token per row (``toks`` at per-row write positions ``pos``),
    gathers each row's context from its block table (the plain paged read),
    overwrites the slot at ``pos`` with the fresh K/V in-context, masks
    positions ``> pos``, scatters the new K/V into the pool IN PLACE and
    returns ``(kpool, vpool, next_tokens)``. Padding rows point their tables
    at the trash block with ``pos = 0``; their outputs are ignored."""
    KV, D = arch["kv_heads"], arch["head_dim"]
    T_pad = block_size * max_blocks

    def logits_fn(params, kpool, vpool, tables, pos, toks):
        tl, pl = tables.long(), pos.long()
        x = arch["embed_rows"](params, toks.long(), pl)
        bids = tl.gather(1, (pl // block_size)[:, None])[:, 0]
        offs = pl % block_size
        live = torch.arange(T_pad, device=pl.device)[None, :] <= pl[:, None]
        for li, w in enumerate(params["layers"]):
            k_ctx = kpool[li][tl].reshape(B, T_pad, KV, D)
            v_ctx = vpool[li][tl].reshape(B, T_pad, KV, D)
            x, k_new, v_new = arch["block_rows"](w, x, k_ctx, v_ctx, live, pl)
            kpool[li][bids, offs] = k_new
            vpool[li][bids, offs] = v_new
        return arch["head"](params, x)

    return _decode_step(logits_fn)


def build_paged_decode_kernel(arch, B, block_size, max_blocks):
    """``build_paged_decode`` with the attention read done by the
    paged-attention kernel (``ops/kernels/paged_attention``): no dense
    context is gathered, and the fresh K/V is scattered into the pool BEFORE
    the kernel reads it (the gather path overwrites its private copy at
    ``pos`` — the same values in the same slot). Same signature and
    sampling. ``tables`` and ``pos`` must be int32."""

    def logits_fn(params, kpool, vpool, tables, pos, toks):
        tl, pl = tables.long(), pos.long()
        x = arch["embed_rows"](params, toks.long(), pl)
        bids = tl.gather(1, (pl // block_size)[:, None])[:, 0]
        offs = pl % block_size
        for li, w in enumerate(params["layers"]):
            q, k_new, v_new = arch["qkv_rows"](w, x, pl)
            kpool[li][bids, offs] = k_new
            vpool[li][bids, offs] = v_new
            o = paged_attention_rows(q.contiguous(), kpool[li], vpool[li],
                                     tables, pos)
            x = arch["attn_out_rows"](w, x, o[:, None])
        return arch["head"](params, x)

    return _decode_step(logits_fn)
