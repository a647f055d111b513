"""Dense and paged KV-cached decode (port of
``paddle_tpu/models/generation.py``).

``generate`` (GPT, greedy, sampled or beam search) and ``generate_llama``
run the reference's dense decode: a prefill into a dense (B, T_max, KV, D)
cache per layer, then one token a row a step through the plugs'
``embed_token`` and ``block(w, x, kv, pos)``. The reference jits each
decode into one program; the port runs the loop eagerly on the card, like
the engine's steps (see ``_build_decode`` for where it syncs).
``last_decode_steps()`` gives the last loop's trip count and
``top_k_top_p_filtering`` the sampling filter.

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
  by the paged-attention kernel straight out of the pool;
* ``build_paged_tail_prefill`` — a multi-token "tail" feed at absolute
  positions against the gathered context: the prompt tail after a cached
  prefix, or one chunk of a chunked prefill;
* ``build_paged_spec_decode`` — the speculative verify: k+1 tokens a row in
  one step, the greedy continuation at every fed position;
* ``build_window_draft`` — a small model drafter's k greedy proposals over
  a dense window of each row's newest tokens;
* ``kv_block_checksums`` — per-block content fingerprints of the pools, the
  check a serving snapshot's adoption runs before it resumes sequences on
  the captured blocks.

Where the reference rebuilt the pools functionally (``kpool.at[...].set``),
these functions update ``kpool``/``vpool`` **in place** (``index_put_``) and
return the same tensors. Greedy rows take ``argmax``; sampled rows
(``temps > 0``) draw from an explicit ``torch.Generator`` (Gumbel-max), which
cannot reproduce JAX's bits — parity with the reference is pinned on greedy
rows only. Weight trees may be plain dicts of tensors or the lazy
dequantizing view of ``serving/int8.py`` (``take`` gathers int8 rows first).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.functional.norm import layer_norm
from ..ops.kernels import int8_matmul, paged_attention_rows
from .llama import rope_angles, rotate_pairs


def _table_cols(tables, cols, max_blocks):
    """``tables``' block ids at columns ``cols`` (B, n); columns past the
    table give the trash block 0."""
    bids = tables.gather(1, cols.clamp(max=max_blocks - 1))
    return torch.where(cols < max_blocks, bids, torch.zeros_like(bids))


def _write_feeds(k_ctx, v_ctx, k_new, v_new, starts):
    """Overwrite the gathered context's slots ``starts + [0..T)`` of each row
    with the T fed tokens' fresh K/V (B, T, KV, D), in place. Feeds past the
    context (only padding reaches them) are dropped, as the reference's
    scatter drops them: each is sent to the context's last slot carrying
    the value that slot's own feed writes, so every write there agrees."""
    B, T = k_new.shape[:2]
    rows = torch.arange(B, device=k_new.device)[:, None]
    jj = torch.arange(T, device=k_new.device)[None, :].minimum(
        k_ctx.shape[1] - 1 - starts[:, None])
    k_ctx[rows, starts[:, None] + jj] = k_new[rows, jj]
    v_ctx[rows, starts[:, None] + jj] = v_new[rows, jj]


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


def _dense_attention(q, k, v, kv, pos, rep):
    """The attention of a plug's ``block``: causal over the T fed tokens
    (``kv`` None: returns their K/V), or the fed tokens' K/V written into
    the dense cache ``kv`` at ``pos`` (in place) and attention over its
    positions <= pos (returns the cache)."""
    if kv is None:
        T = q.shape[1]
        live = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        return _grouped_attention(q, k, v, live[None, None, None], rep), \
            (k, v)
    kc, vc = kv
    kc[:, pos:pos + k.shape[1]] = k
    vc[:, pos:pos + v.shape[1]] = v
    live = torch.arange(kc.shape[1], device=q.device) <= pos
    return _grouped_attention(q, kc, vc, live, rep), (kc, vc)


def _ln(x, w, b, eps=1e-5):
    return layer_norm(x, w.shape, w, b, eps)


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


def _gpt_arch(H, D, n_pos):
    def embed_prompt(params, ids, T0):
        wpe = _rows(params, "wpe", torch.arange(T0, device=ids.device))
        return _rows(params, "wte", ids) + wpe[None]

    def embed_rows(params, toks, pos):
        # packed decode: one token per row at per-row absolute positions —
        # toks (B,), pos (B,) -> (B, 1, H·D)
        return (_rows(params, "wte", toks) + _rows(params, "wpe", pos))[:, None]

    def embed_tail(params, ids, starts):
        # T tokens a row at absolute positions starts + [0..T); a position
        # past the table reads its last row, as the reference's gather
        # clamps (only padding and feeds past a sequence's budget reach it)
        pos = starts[:, None] + torch.arange(ids.shape[1], device=ids.device)
        return _rows(params, "wte", ids) + _rows(params, "wpe",
                                                 pos.clamp(max=n_pos - 1))

    def head_rows(params, x, idx):
        # logits at each row's own position; the norm is per row, so picking
        # the rows first gives the reference's values
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return _head_mm(params, _ln(rows, params["lnf_w"], params["lnf_b"]),
                        "wte", True)

    def head_all(params, x):
        # logits at EVERY fed position (the speculative verify reads all k+1)
        return _head_mm(params, _ln(x, params["lnf_w"], params["lnf_b"]),
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

    def block_tail(w, x, k_ctx, v_ctx, live, starts):
        # T consecutive tokens a row, x (B,T,H·D), at absolute positions
        # starts + [0..T) against a GATHERED paged context (the step's
        # private copy): their fresh K/V overwrite the in-context slots
        # before the joint causal attention, so feed j sees the cached
        # context plus feeds <= j; live (B,T,Tp) masks per (row, feed). The
        # caller scatters (k_new, v_new) (B,T,KV,D) into the pool.
        B, T = x.shape[0], x.shape[1]
        h = _ln(x, w["ln1_w"], w["ln1_b"])
        qkv = (h @ w["qkv_w"] + w["qkv_b"]).reshape(B, T, 3, H, D)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        _write_feeds(k_ctx, v_ctx, k_new, v_new, starts)
        o = _grouped_attention(q, k_ctx, v_ctx, live[:, None, None], rep=1)
        return attn_out_rows(w, x, o), k_new, v_new

    def embed_token(params, tok, pos):
        # one token a row at the shared position pos (dense decode)
        wpe = _rows(params, "wpe", torch.full((1,), pos, device=tok.device))
        return (_rows(params, "wte", tok) + wpe)[:, None]

    def block(w, x, kv=None, pos=None):
        # dense causal pass over x (B,T,H·D): a prompt batch (kv None,
        # returns its K/V), or T tokens at positions pos.. against the dense
        # cache kv = (kc, vc) (B,T_max,KV,D), whose slots pos..pos+T-1 it
        # writes in place before attending over positions <= pos
        B, T = x.shape[0], x.shape[1]
        h = _ln(x, w["ln1_w"], w["ln1_b"])
        qkv = (h @ w["qkv_w"] + w["qkv_b"]).reshape(B, T, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o, new_kv = _dense_attention(q, k, v, kv, pos, rep=1)
        return mlp_out(w, x + (o @ w["proj_w"] + w["proj_b"])), new_kv

    def head(params, x):
        return _head_mm(params, _ln(x[:, -1], params["lnf_w"], params["lnf_b"]),
                        "wte", True)  # tied head

    return {"embed_prompt": embed_prompt, "embed_token": embed_token,
            "embed_rows": embed_rows,
            "embed_tail": embed_tail, "head_rows": head_rows,
            "head_all": head_all, "block_rows": block_rows,
            "block_tail": block_tail, "qkv_rows": qkv_rows,
            "attn_out_rows": attn_out_rows, "block": block, "head": head,
            "kv_heads": H, "head_dim": D}


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
    n_pos = cfg.max_position_embeddings
    return arch_key, _gpt_arch(H, D, n_pos), params, n_pos


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


def _rope_grid(x, pos, theta):
    """Rotary embedding at a per-(row, token) position grid (tail prefill,
    speculative verify): x (B, T, H, D), pos (B, T) int."""
    ang = rope_angles(pos.float(), x.shape[-1], theta)  # (B, T, D/2)
    return _rotate(x, ang[:, :, None, :])


def _llama_arch(H, KV, D, theta, eps):
    rep = H // KV

    def embed_prompt(params, ids, T0):
        return _rows(params, "wte", ids)

    def embed_rows(params, toks, pos):
        return _rows(params, "wte", toks)[:, None]

    def embed_tail(params, ids, starts):
        return _rows(params, "wte", ids)

    def head_rows(params, x, idx):
        # the norm is per row, so picking the rows first gives the
        # reference's values
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        return _head_mm(params, _rms(rows, params["lnf_w"], eps), "head_w",
                        False)

    def head_all(params, x):
        return _head_mm(params, _rms(x, params["lnf_w"], eps), "head_w",
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

    def block_tail(w, x, k_ctx, v_ctx, live, starts):
        # see the GPT plug for the contract; RoPE at each (row, feed)'s own
        # absolute position, GQA against the un-repeated gathered cache
        B, T = x.shape[0], x.shape[1]
        posm = starts[:, None] + torch.arange(T, device=x.device)[None, :]
        h = _rms(x, w["ln1_w"], eps)
        q = _rope_grid((h @ w["q_w"]).reshape(B, T, H, D), posm, theta)
        k_new = _rope_grid((h @ w["k_w"]).reshape(B, T, KV, D), posm, theta)
        v_new = (h @ w["v_w"]).reshape(B, T, KV, D)
        _write_feeds(k_ctx, v_ctx, k_new, v_new, starts)
        o = _grouped_attention(q, k_ctx, v_ctx, live[:, None, None], rep)
        return attn_out_rows(w, x, o), k_new, v_new

    def embed_token(params, tok, pos):
        return _rows(params, "wte", tok)[:, None]

    def block(w, x, kv=None, pos=None):
        # see the GPT plug for the contract; RoPE at positions pos.. (0..
        # for a prompt); the cache holds the KV heads, never the repeats
        B, T = x.shape[0], x.shape[1]
        pos0 = 0.0 if kv is None else float(pos)
        h = _rms(x, w["ln1_w"], eps)
        q = _rope_at((h @ w["q_w"]).reshape(B, T, H, D), pos0, theta)
        k = _rope_at((h @ w["k_w"]).reshape(B, T, KV, D), pos0, theta)
        v = (h @ w["v_w"]).reshape(B, T, KV, D)
        o, new_kv = _dense_attention(q, k, v, kv, pos, rep)
        return attn_out_rows(w, x, o), new_kv

    def head(params, x):
        return _head_mm(params, _rms(x[:, -1], params["lnf_w"], eps),
                        "head_w", False)  # untied head, (h, V)

    return {"embed_prompt": embed_prompt, "embed_token": embed_token,
            "embed_rows": embed_rows,
            "embed_tail": embed_tail, "head_rows": head_rows,
            "head_all": head_all, "block_rows": block_rows,
            "block_tail": block_tail, "qkv_rows": qkv_rows,
            "attn_out_rows": attn_out_rows, "block": block, "head": head,
            "kv_heads": KV, "head_dim": D}


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


# blocks a checksum gathers at once: bounds the temporary copy (a block of
# GPT-3 1.3B's pools is 1.5 MB, of Llama-7B's 4 MB)
_CHECKSUM_CHUNK = 64


def kv_block_checksums(kpool, vpool, bids):
    """Per-block content fingerprints of paged KV state: for each block id in
    ``bids``, ``(sum |K|, sum |V|)`` over that block's rows in every layer,
    summed in f32. Returns float64 numpy of shape ``(len(bids), 2)``.

    ``Engine.snapshot`` records them for every owned block and
    ``Engine.adopt`` recomputes them over the handed-over pools: a mismatch
    is a rejected snapshot, never a wrong-KV serve. The reduction gathers a
    fixed chunk of blocks and sums each block's row in one f32 reduction
    (no atomics), so the same pools and ids give the same bits on the card,
    as a clean handoff needs. Reads the pools on the device they live on;
    the caller synchronizes with any work still writing them.

    Tensor-parallel pools come as lists of shards (L, NB, BS, KV/tp, D):
    each chunk's blocks are gathered on the KV-head axis onto the first
    shard's device before the same reduction, so a block's checksum equals
    the one-device engine's for the same contents."""
    if not len(bids):
        return np.zeros((0, 2), dtype=np.float64)
    sharded = isinstance(kpool, (list, tuple))
    dev = kpool[0].device if sharded else kpool.device
    idx = torch.as_tensor(np.asarray(bids, dtype=np.int64), device=dev)

    def blocks(pool, part):
        if not sharded:
            return pool.index_select(1, part)
        return torch.cat([p.index_select(1, part.to(p.device)).to(dev)
                          for p in pool], dim=3)

    out = []
    for lo in range(0, len(idx), _CHECKSUM_CHUNK):
        part = idx[lo:lo + _CHECKSUM_CHUNK]
        sums = [blocks(pool, part).abs_().transpose(0, 1)
                .reshape(len(part), -1).sum(1, dtype=torch.float32)
                for pool in (kpool, vpool)]
        out.append(torch.stack(sums, 1))
    return torch.cat(out).cpu().numpy().astype(np.float64)


def build_paged_tail_prefill(arch, B, T_bucket, block_size, max_blocks):
    """Tail prefill: each row's prompt head already lives in pool blocks (a
    shared prefix-cache chain, or earlier chunks of a chunked prefill), and
    only its tail runs the forward pass.

    ``prefill(params, ids, starts, lens, tables, kpool, vpool)`` feeds each
    row's tail ``ids`` (B, T_bucket, padded) at absolute positions
    ``starts + [0..T)`` (``starts`` a multiple of ``block_size``), gathers
    the row's context through its table (``tables`` (B, max_blocks)),
    overwrites the tail's in-context slots with fresh K/V before the joint
    causal attention (tail token j sees the cached head plus tail tokens
    <= j), scatters the tail's blocks into the pool IN PLACE at table
    columns ``starts // block_size + j`` (columns past the table go to the
    trash block 0) and returns ``(kpool, vpool, logits)`` at each row's last
    tail token (``lens - 1``). Each layer's context is gathered before that
    layer's scatter; the head's blocks lie below every written column, so a
    tail never writes a block another table shares."""
    KV, D = arch["kv_heads"], arch["head_dim"]
    if T_bucket % block_size:
        raise ValueError(f"tail-prefill bucket {T_bucket} must be a multiple "
                         f"of block_size {block_size}")
    nb = T_bucket // block_size
    T_pad = block_size * max_blocks

    def prefill(params, ids, starts, lens, tables, kpool, vpool):
        tl, st = tables.long(), starts.long()
        dev = st.device
        x = arch["embed_tail"](params, ids.long(), st)
        posm = st[:, None] + torch.arange(T_bucket, device=dev)[None, :]
        live = torch.arange(T_pad, device=dev)[None, None, :] \
            <= posm[:, :, None]  # (B, T, Tp)
        bids = _table_cols(tl, (st // block_size)[:, None]
                           + torch.arange(nb, device=dev)[None, :], max_blocks)
        for li, w in enumerate(params["layers"]):
            k_ctx = kpool[li][tl].reshape(B, T_pad, KV, D)
            v_ctx = vpool[li][tl].reshape(B, T_pad, KV, D)
            x, k_new, v_new = arch["block_tail"](w, x, k_ctx, v_ctx, live, st)
            kpool[li][bids] = k_new.reshape(B, nb, block_size, KV, D)
            vpool[li][bids] = v_new.reshape(B, nb, block_size, KV, D)
        return kpool, vpool, arch["head_rows"](params, x, lens.long() - 1)

    return prefill


def build_paged_spec_decode(arch, B, k, block_size, max_blocks):
    """Speculative verify: ONE packed decode step that feeds k+1 tokens a
    row — the row's pending next-input token, then k drafted tokens — and
    returns the greedy continuation at EVERY fed position.

    ``step(params, kpool, vpool, tables, pos, toks, temps, generator)``
    takes ``toks`` (B, k+1) fed at absolute positions ``pos + [0..k]``,
    gathers each row's context through its table (the plain paged read, as
    the reference keeps it for this step), overwrites the k+1 in-context
    slots with fresh K/V before the joint causal attention (feed j attends
    to the cache plus feeds <= j: the logits at j are those of j sequential
    decode steps), scatters all k+1 into the pool IN PLACE (slots past the
    table go to the trash block) and returns ``(kpool, vpool, greedy,
    sampled)``: ``greedy`` (B, k+1) the argmax at each feed, ``sampled``
    (B,) the j = 0 token drawn at ``temps`` from ``generator`` as the decode
    step draws (greedy where ``temps == 0``; sampling rows accept no
    drafts). K/V written for a rejected feed is overwritten by a later step
    before any feed reads it. ``step.logits`` is the step before sampling,
    (B, k+1, V)."""
    KV, D = arch["kv_heads"], arch["head_dim"]
    T = k + 1
    T_pad = block_size * max_blocks

    def logits_fn(params, kpool, vpool, tables, pos, toks):
        tl, pl = tables.long(), pos.long()
        x = arch["embed_tail"](params, toks.long(), pl)
        posm = pl[:, None] + torch.arange(T, device=pl.device)[None, :]
        live = torch.arange(T_pad, device=pl.device)[None, None, :] \
            <= posm[:, :, None]
        bids = _table_cols(tl, posm // block_size, max_blocks)
        offs = posm % block_size
        for li, w in enumerate(params["layers"]):
            k_ctx = kpool[li][tl].reshape(B, T_pad, KV, D)
            v_ctx = vpool[li][tl].reshape(B, T_pad, KV, D)
            x, k_new, v_new = arch["block_tail"](w, x, k_ctx, v_ctx, live, pl)
            kpool[li][bids, offs] = k_new
            vpool[li][bids, offs] = v_new
        return arch["head_all"](params, x)

    def step(params, kpool, vpool, tables, pos, toks, temps, generator=None):
        logits = logits_fn(params, kpool, vpool, tables, pos, toks)
        greedy = logits.argmax(-1).to(torch.int32)
        return kpool, vpool, greedy, _sample(logits[:, 0], temps, generator)

    step.logits = logits_fn
    return step


def build_window_draft(arch, B, W, k):
    """Model drafter: k greedy proposals a row from a SMALL same-family
    model over a dense window of each row's newest ``W`` tokens.

    ``draft(params, ids, lens)`` prefills the window (``ids`` (B, W)
    left-aligned, ``lens`` the real lengths in [1, W]) at window-relative
    positions — past the window a position-embedding drafter is only
    approximate, which costs acceptance, never correctness: the target
    verifies every proposal — then runs k single-token greedy steps against
    a dense per-row cache (``block_rows`` writes each fresh K/V into it in
    place) and returns the proposals (B, k) int32."""
    T_max = W + k

    def draft(params, ids, lens):
        ll = lens.long()
        x = arch["embed_prompt"](params, ids.long(), W)
        caches = []
        for w in params["layers"]:
            x, (kk, vv) = arch["block"](w, x)
            kc = kk.new_zeros((B, T_max) + kk.shape[2:])
            vc = vv.new_zeros((B, T_max) + vv.shape[2:])
            kc[:, :W] = kk
            vc[:, :W] = vv
            caches.append((kc, vc))
        logits = arch["head_rows"](params, x, ll - 1)
        out = torch.zeros((B, k), dtype=torch.int32, device=ids.device)
        for j in range(k):
            nxt = logits.argmax(-1)
            out[:, j] = nxt
            pos = ll + j  # each row's write position of the new token
            x = arch["embed_rows"](params, nxt, pos)
            live = torch.arange(T_max, device=pos.device)[None, :] \
                <= pos[:, None]
            for w, (kc, vc) in zip(params["layers"], caches):
                x, _, _ = arch["block_rows"](w, x, kc, vc, live, pos)
            logits = arch["head"](params, x)
        return out

    return draft


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------
# The tp builders shard attention heads, FFN columns and the LM head's vocab
# rows over tp shards; every tp boundary is a CONCAT of column shards (each
# shard's output copied to the consumer's device and joined on the last
# axis), never a sum of partial products. Every element of a gathered
# tensor is then the dot product the one-device step computes, and the
# replicated work after a gather (the attention projection, the FFN down
# projection, the head's argmax) runs once, on the consumer's device, on
# the same inputs: greedy decode keeps the one-device engine's tokens as
# long as a column slice of a product is computed as the product's columns
# (on the H100 Llama-7B's bf16 q/k/v projections are not; ROADMAP §C).
# Embeddings and norms stay replicated; GPT's tied head gets its own
# vocab-row-sharded copy of wte while the replicated wte keeps serving the
# embedding lookup. A shard is a weight tree of its own on its own device,
# each leaf contiguous, and so is its KV pool (L, NB, BS, KV/tp, D); the
# host-side block tables, PagePool bookkeeping and scheduler state stay
# replicated, so pool conservation, prefix chaining, snapshot/adopt and
# preemption are unchanged.

_INT8_TAG = "__int8__"  # serving/int8.quantize_params's leaf encoding


def _tp_dims(arch_key):
    """(kind, H, KV, D, L, theta, eps) from a decode-state ``arch_key``."""
    if arch_key[0] == "gpt":
        _, H, D, L = arch_key
        return "gpt", H, H, D, L, None, None
    _, H, KV, D, L, theta, eps = arch_key
    return "llama", H, KV, D, L, theta, eps


def _tp_leaf(leaf, fn):
    """``fn`` applied to a weight leaf, looking through the int8 tagged
    encoding. The scale is per tensor, so slice-then-dequantize is bitwise
    dequantize-then-slice: an int8 engine shards the int8 bytes and each
    shard dequantizes its own leaves."""
    if isinstance(leaf, dict) and _INT8_TAG in leaf:
        return {_INT8_TAG: fn(leaf[_INT8_TAG]), "scale": leaf["scale"]}
    return fn(leaf)


def _tp_shape(leaf):
    if isinstance(leaf, dict) and _INT8_TAG in leaf:
        return tuple(leaf[_INT8_TAG].shape)
    return tuple(leaf.shape)


def tp_validate(arch_key, params, tp):
    """Shard-divisibility requirements for a tp degree; returns
    ``(ffn_width, vocab)``. Heads, kv heads and the FFN width must divide
    evenly (the vocab is zero-padded to a tp multiple instead: the padded
    logits are sliced off after the gather, so they never win argmax)."""
    kind, H, KV, D, L, _, _ = _tp_dims(arch_key)
    ffn = _tp_shape(params["layers"][0]["up_w"])[1]
    vocab = (_tp_shape(params["wte"])[0] if kind == "gpt"
             else _tp_shape(params["head_w"])[1])
    for name, n in (("attention heads", H), ("kv heads", KV),
                    ("ffn width", ffn)):
        if n % tp:
            raise ValueError(
                f"serving: tp={tp} must divide the model's {name} ({n})")
    return ffn, vocab


def _tp_place(node, device):
    """Every tensor of a weight tree contiguous on ``device``."""
    if isinstance(node, dict):
        return {k: _tp_place(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_tp_place(v, device) for v in node]
    if device is None:
        return node.contiguous()
    return node.contiguous().to(device)


def tp_pack_params(arch_key, params, tp, devices=None):
    """Split a decode weight tree (float or int8-tagged) into
    ``({"rep": replicated_tree, "shard": [tree_0, ..., tree_{tp-1}]},
    vocab)``.

    ``rep`` holds the replicated leaves themselves (no copy); shard ``d``
    holds, per sharded weight, its column slice, contiguous, on
    ``devices[d]`` (each leaf's own device when None). GPT's fused qkv is
    sliced through its (H·D, 3, H, D) view, so each shard owns whole
    (q, k, v) triples for its heads; the head weight is vocab-sliced after
    zero-padding the vocab to a tp multiple."""
    kind, H, KV, D, L, _, _ = _tp_dims(arch_key)
    ffn, vocab = tp_validate(arch_key, params, tp)
    Hl, KVl, Fl = H // tp, KV // tp, ffn // tp
    HD = H * D
    Vl = -(-vocab // tp)

    def vocab_slice(a, axis, d):
        # shard d's Vl vocab entries of the zero-padded vocab
        lo = d * Vl
        part = a.narrow(axis, lo, max(0, min(lo + Vl, vocab) - lo))
        if part.shape[axis] == Vl:
            return part
        shape = list(a.shape)
        shape[axis] = Vl - part.shape[axis]
        return torch.cat([part, a.new_zeros(shape)], dim=axis)

    def cols(a, d, n):
        return a[:, d * n:(d + 1) * n]

    def heads(a, n_heads, d, n):
        # (HD, n_heads * D) -> shard d's n heads of D columns each
        return a.reshape(HD, n_heads, D)[:, d * n:(d + 1) * n].reshape(
            HD, n * D)

    def dev_tree(d):
        if kind == "gpt":
            head = _tp_leaf(params["wte"], lambda a: vocab_slice(a, 0, d))
            layers = [{
                "qkv_w": _tp_leaf(w["qkv_w"], lambda a: a.reshape(
                    HD, 3, H, D)[:, :, d * Hl:(d + 1) * Hl].reshape(
                        HD, 3 * Hl * D)),
                "qkv_b": w["qkv_b"].reshape(3, H, D)[
                    :, d * Hl:(d + 1) * Hl].reshape(-1),
                "up_w": _tp_leaf(w["up_w"], lambda a: cols(a, d, Fl)),
                "up_b": w["up_b"][d * Fl:(d + 1) * Fl],
            } for w in params["layers"]]
        else:
            head = _tp_leaf(params["head_w"],
                            lambda a: vocab_slice(a, 1, d))
            layers = [{
                "q_w": _tp_leaf(w["q_w"], lambda a: heads(a, H, d, Hl)),
                "k_w": _tp_leaf(w["k_w"], lambda a: heads(a, KV, d, KVl)),
                "v_w": _tp_leaf(w["v_w"], lambda a: heads(a, KV, d, KVl)),
                "gate_w": _tp_leaf(w["gate_w"], lambda a: cols(a, d, Fl)),
                "up_w": _tp_leaf(w["up_w"], lambda a: cols(a, d, Fl)),
            } for w in params["layers"]]
        tree = {"head_w": head, "layers": layers}
        return _tp_place(tree, None if devices is None else devices[d])

    if kind == "gpt":
        rep = {k: params[k] for k in ("wte", "wpe", "lnf_w", "lnf_b")}
        rep_keys = ("ln1_w", "ln1_b", "proj_w", "proj_b", "ln2_w", "ln2_b",
                    "down_w", "down_b")
    else:
        rep = {k: params[k] for k in ("wte", "lnf_w")}
        rep_keys = ("ln1_w", "o_w", "ln2_w", "down_w")
    rep["layers"] = [{k: w[k] for k in rep_keys} for w in params["layers"]]
    return {"rep": rep, "shard": [dev_tree(d) for d in range(tp)]}, vocab


def tp_collective_bytes(arch_key, params, B, tp):
    """A decode step's tensor-parallel gather payload as ``(fp32_bytes,
    int8_bytes)``: the attention output and the FFN intermediate a layer,
    plus the padded logits, over all shards. The int8 figure includes the
    f32 blockwise scales (one per 128 elements, each shard's payload padded
    to a whole block), what the ``tp_int8`` wire really carries."""
    kind, H, KV, D, L, _, _ = _tp_dims(arch_key)
    ffn, vocab = tp_validate(arch_key, params, tp)
    vp = -(-vocab // tp) * tp
    sizes = [B * H * D, B * ffn] * L + [B * vp]

    def wire(n, int8):
        if not int8:
            return n * 4
        blocks = -(-(n // tp) // 128)
        return tp * blocks * (128 * 1 + 4)

    return (sum(wire(n, False) for n in sizes),
            sum(wire(n, True) for n in sizes))


def _tp_gather(parts, quantized, device):
    """The tp boundary: each shard's column block (on its own device) copied
    to ``device`` and concatenated on the last axis. Exact: every element is
    the value one shard computed. With ``quantized`` (``tp_int8``) each
    block crosses as blockwise int8 with f32 scales (padded to 128
    elements) and is dequantized shard by shard: about 3.9x fewer bytes,
    LOSSY (greedy tokens may differ). The bytes that cross are counted in
    ``serve_tp_gather_bytes``."""
    from ..profiler import counter_inc

    if not quantized:
        counter_inc("serve_tp_gather_bytes",
                    sum(p.numel() * p.element_size() for p in parts))
        return torch.cat([p.to(device) for p in parts], dim=-1)
    from ..distributed.collective import (blockwise_dequantize,
                                          blockwise_quantize)

    out, wire = [], 0
    for p in parts:
        flat = p.reshape(-1)
        m = flat.shape[0]
        pad = -m % 128
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        q, s = blockwise_quantize(flat)
        q, s = q.to(device), s.to(device)
        wire += q.numel() + s.numel() * 4
        out.append(blockwise_dequantize(q, s, p.dtype)[:m].reshape(p.shape))
    counter_inc("serve_tp_gather_bytes", wire)
    return torch.cat(out, dim=-1)


def _has_int8(tree) -> bool:
    return any(isinstance(v, dict) and _INT8_TAG in v
               for v in tree["layers"][0].values())


def _tp_view(tree, dtype):
    """A shard's (or the replicated part's) weights to compute with: its
    int8 leaves dequantized on read, on its own device, as the one-device
    int8 engine reads them."""
    from ..serving.int8 import dequantize_tree

    return dequantize_tree(tree, dtype) if _has_int8(tree) else tree


def _tp_arch(arch_key, tp, vocab, int8_wire, devices):
    """The tp step's layer drivers over the consumer (``devices[0]``, where
    the replicated work runs) and the shards: the replicated norm, the
    column-sharded projections and local grouped attention of each shard, a
    gather at the attention and FFN boundaries, the replicated second
    matmuls. Op for op the one-device plugs and the gather is an exact
    concat, so a gathered tensor is the one-device activation bit for bit
    where the backend computes each shard's column slice of a product as
    the full product's columns: on the H100, cuBLAS's bf16 q/k/v
    projections of Llama-7B at half the columns round otherwise (ROADMAP
    §C)."""
    kind, H, KV, D, L, theta, eps = _tp_dims(arch_key)
    Hl, KVl = H // tp, KV // tp
    rep = H // KV  # the GQA group width is tp-invariant (both axes sharded)
    gpt = kind == "gpt"
    dev0 = devices[0]

    def gather(parts):
        return _tp_gather(parts, int8_wire, dev0)

    def on(t):
        # t on every shard's device (the same tensor where it already is)
        return [t if t.device == d else t.to(d) for d in devices]

    def embed(rep, rw, ids, pos):
        # tokens at absolute positions; a position past GPT's table reads
        # its last row, as the reference's gather clamps (only padding and
        # feeds past a sequence's budget reach it)
        if gpt:
            n_pos = _tp_shape(rep["wpe"])[0]
            return _rows(rw, "wte", ids) + _rows(rw, "wpe",
                                                 pos.clamp(max=n_pos - 1))
        return _rows(rw, "wte", ids)

    def pre(rwl, x):
        if gpt:
            return _ln(x, rwl["ln1_w"], rwl["ln1_b"])
        return _rms(x, rwl["ln1_w"], eps)

    def proj(swl, h, posm):
        # one shard's column-sharded projections of h (B,T,H·D): q
        # (B,T,Hl,D), k and v (B,T,KVl,D), RoPE at the (row, token) grid
        B, T = h.shape[0], h.shape[1]
        if gpt:
            qkv = (h @ swl["qkv_w"] + swl["qkv_b"]).reshape(B, T, 3, Hl, D)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = (h @ swl["q_w"]).reshape(B, T, Hl, D)
        k = (h @ swl["k_w"]).reshape(B, T, KVl, D)
        v = (h @ swl["v_w"]).reshape(B, T, KVl, D)
        return _rope_grid(q, posm, theta), _rope_grid(k, posm, theta), v

    def post_attn(rwl, swls, x, o_parts):
        # the shards' attention reads (B,T,Hl·D) gathered to the full heads,
        # then the replicated projection, the sharded FFN columns, gathered,
        # and the replicated down projection
        o = gather(o_parts)
        if gpt:
            x = x + (o @ rwl["proj_w"] + rwl["proj_b"])
            h2s = on(_ln(x, rwl["ln2_w"], rwl["ln2_b"]))
            ff = gather([F.gelu(h2 @ sw["up_w"] + sw["up_b"],
                                approximate="tanh")
                         for h2, sw in zip(h2s, swls)])
            return x + (ff @ rwl["down_w"] + rwl["down_b"])
        x = x + o @ rwl["o_w"]
        h2s = on(_rms(x, rwl["ln2_w"], eps))
        ff = gather([F.silu(h2 @ sw["gate_w"]) * (h2 @ sw["up_w"])
                     for h2, sw in zip(h2s, swls)])
        return x + ff @ rwl["down_w"]

    def head_rows(rw, sws, x, idx):
        rows = x[torch.arange(x.shape[0], device=x.device), idx]
        h = _ln(rows, rw["lnf_w"], rw["lnf_b"]) if gpt \
            else _rms(rows, rw["lnf_w"], eps)
        parts = [hd @ (sw["head_w"].T if gpt else sw["head_w"])
                 for hd, sw in zip(on(h), sws)]
        # the padded vocab columns are sliced off after the gather
        return gather(parts)[:, :vocab]

    return {"embed": embed, "pre": pre, "proj": proj, "on": on,
            "post_attn": post_attn, "head_rows": head_rows,
            "kv_local": KVl, "head_dim": D, "rep": rep, "n_layers": L}


def _tp_weights(packed, dtype):
    return (_tp_view(packed["rep"], dtype),
            [_tp_view(s, dtype) for s in packed["shard"]])


def _tp_kernel_config(B, MB, BS, KV, rep, D, dtype, device):
    """The paged kernel's config for a shard: the one the UNSHARDED (B, KV)
    resolves to, the kernel's own cluster-size rule (``split_for``) taken at
    the unsharded shape. At KV/tp the rule can pick a larger split, which
    changes the merge order of a row's partial results and can flip a greedy
    token against the one-device engine; with the unsharded split each
    (row, head) is computed as the one-device step computes it."""
    from ..ops.kernels import paged_attention as P
    from ..ops.kernels.registry import launch_config

    config = dict(launch_config("paged_attention", P.paged_attention_key, B,
                                MB, BS, KV, rep, D, dtype))
    if int(config["split"]) == 0:
        config["split"] = P.rule_split(B, KV, BS, MB, device)
    return config


def build_tp_paged_decode(arch_key, B, block_size, max_blocks, devices, vocab,
                          dtype, use_kernel=False, int8_wire=False):
    """Tensor-parallel ``build_paged_decode`` (``build_paged_decode_kernel``
    with ``use_kernel``): the same step, ``step(packed, kpools, vpools,
    tables, pos, toks, temps, generator)``, with :func:`tp_pack_params`'s
    tree in place of ``params`` and one (L, NB, BS, KV/tp, D) pool a shard
    (``kpools[d]`` on ``devices[d]``) in place of the pools; tables,
    positions and tokens are the consumer's. The kernel path launches the
    paged-attention kernel on each shard's own contiguous layer pool, at
    KV/tp heads and the unsharded shape's cluster size
    (``_tp_kernel_config``)."""
    tp = len(devices)
    A = _tp_arch(arch_key, tp, vocab, int8_wire, devices)
    KVl, D, rep = A["kv_local"], A["head_dim"], A["rep"]
    T_pad = block_size * max_blocks
    config = {}

    def logits_fn(packed, kpools, vpools, tables, pos, toks):
        rw, sws = _tp_weights(packed, dtype)
        tl, pl = tables.long(), pos.long()
        x = A["embed"](packed["rep"], rw, toks.long(), pl)[:, None]
        bids = tl.gather(1, (pl // block_size)[:, None])[:, 0]
        offs = pl % block_size
        tls, pls, bidss, offss = (A["on"](t) for t in (tl, pl, bids, offs))
        if use_kernel:
            tabs, poss = A["on"](tables), A["on"](pos)
            if not config and tables.device.type == "cuda":
                config["c"] = _tp_kernel_config(
                    B, max_blocks, block_size, KVl * tp, rep, D, dtype,
                    tables.device)
        else:
            lives = A["on"](torch.arange(T_pad, device=pl.device)[None, :]
                            <= pl[:, None])
        for li in range(len(packed["rep"]["layers"])):
            rwl = rw["layers"][li]
            swls = [sw["layers"][li] for sw in sws]
            hs = A["on"](A["pre"](rwl, x))
            o_parts = []
            for d in range(tp):
                q, k, v = A["proj"](swls[d], hs[d], pls[d][:, None])
                kp, vp = kpools[d][li], vpools[d][li]
                if use_kernel:
                    kp[bidss[d], offss[d]] = k[:, 0]
                    vp[bidss[d], offss[d]] = v[:, 0]
                    o = paged_attention_rows(q[:, 0].contiguous(), kp, vp,
                                             tabs[d], poss[d],
                                             config=config.get("c"))[:, None]
                else:
                    rows = torch.arange(B, device=q.device)
                    k_ctx = kp[tls[d]].reshape(B, T_pad, KVl, D)
                    v_ctx = vp[tls[d]].reshape(B, T_pad, KVl, D)
                    k_ctx[rows, pls[d]] = k[:, 0]
                    v_ctx[rows, pls[d]] = v[:, 0]
                    o = _grouped_attention(
                        q, k_ctx, v_ctx, lives[d][:, None, None, None, :],
                        rep)
                    kp[bidss[d], offss[d]] = k[:, 0]
                    vp[bidss[d], offss[d]] = v[:, 0]
                o_parts.append(o)
            x = A["post_attn"](rwl, swls, x, o_parts)
        return A["head_rows"](rw, sws, x,
                              torch.zeros(B, dtype=torch.long,
                                          device=x.device))

    return _decode_step(logits_fn)


def build_tp_paged_prefill(arch_key, B, T_bucket, block_size, max_blocks,
                           devices, vocab, dtype, int8_wire=False):
    """Tensor-parallel ``build_paged_prefill``: ``prefill(packed, ids, lens,
    tables, kpools, vpools)``; each shard scatters its (B, nb, BS, KV/tp, D)
    K/V into its own pool at the replicated block table."""
    if T_bucket % block_size:
        raise ValueError(f"prefill bucket {T_bucket} must be a multiple of "
                         f"block_size {block_size}")
    nb = T_bucket // block_size
    if nb > max_blocks:
        raise ValueError("prefill bucket exceeds max sequence blocks")
    tp = len(devices)
    A = _tp_arch(arch_key, tp, vocab, int8_wire, devices)
    KVl, D, rep = A["kv_local"], A["head_dim"], A["rep"]

    def prefill(packed, ids, lens, tables, kpools, vpools):
        rw, sws = _tp_weights(packed, dtype)
        dev = ids.device
        ar = torch.arange(T_bucket, device=dev)
        x = A["embed"](packed["rep"], rw, ids.long(), ar[None, :].expand(B, -1))
        posms = A["on"](ar[None, :].expand(B, -1))
        tbs = A["on"](tables[:, :nb].long())
        live = torch.ones(T_bucket, T_bucket, dtype=torch.bool,
                          device=dev).tril()[None, None, None]
        lives = A["on"](live)
        for li in range(len(packed["rep"]["layers"])):
            rwl = rw["layers"][li]
            swls = [sw["layers"][li] for sw in sws]
            hs = A["on"](A["pre"](rwl, x))
            o_parts = []
            for d in range(tp):
                q, k, v = A["proj"](swls[d], hs[d], posms[d])
                o_parts.append(_grouped_attention(q, k, v, lives[d], rep))
                kpools[d][li][tbs[d]] = k.reshape(B, nb, block_size, KVl, D)
                vpools[d][li][tbs[d]] = v.reshape(B, nb, block_size, KVl, D)
            x = A["post_attn"](rwl, swls, x, o_parts)
        return kpools, vpools, A["head_rows"](rw, sws, x, lens.long() - 1)

    return prefill


def build_tp_paged_tail_prefill(arch_key, B, T_bucket, block_size,
                                max_blocks, devices, vocab, dtype,
                                int8_wire=False):
    """Tensor-parallel ``build_paged_tail_prefill`` (also the chunked
    prefill's step): ``prefill(packed, ids, starts, lens, tables, kpools,
    vpools)``; each shard reads its heads of the earlier blocks through the
    replicated table and writes its heads of the tail's blocks."""
    if T_bucket % block_size:
        raise ValueError(f"tail-prefill bucket {T_bucket} must be a multiple "
                         f"of block_size {block_size}")
    nb = T_bucket // block_size
    T_pad = block_size * max_blocks
    tp = len(devices)
    A = _tp_arch(arch_key, tp, vocab, int8_wire, devices)
    KVl, D, rep = A["kv_local"], A["head_dim"], A["rep"]

    def prefill(packed, ids, starts, lens, tables, kpools, vpools):
        rw, sws = _tp_weights(packed, dtype)
        tl, st = tables.long(), starts.long()
        dev = st.device
        posm = st[:, None] + torch.arange(T_bucket, device=dev)[None, :]
        x = A["embed"](packed["rep"], rw, ids.long(), posm)
        live = torch.arange(T_pad, device=dev)[None, None, :] \
            <= posm[:, :, None]  # (B, T, Tp)
        bids = _table_cols(tl, (st // block_size)[:, None]
                           + torch.arange(nb, device=dev)[None, :],
                           max_blocks)
        tls, sts, posms, lives, bidss = (A["on"](t) for t in
                                         (tl, st, posm, live, bids))
        for li in range(len(packed["rep"]["layers"])):
            rwl = rw["layers"][li]
            swls = [sw["layers"][li] for sw in sws]
            hs = A["on"](A["pre"](rwl, x))
            o_parts = []
            for d in range(tp):
                q, k_new, v_new = A["proj"](swls[d], hs[d], posms[d])
                kp, vp = kpools[d][li], vpools[d][li]
                k_ctx = kp[tls[d]].reshape(B, T_pad, KVl, D)
                v_ctx = vp[tls[d]].reshape(B, T_pad, KVl, D)
                _write_feeds(k_ctx, v_ctx, k_new, v_new, sts[d])
                o_parts.append(_grouped_attention(
                    q, k_ctx, v_ctx, lives[d][:, None, None], rep))
                kp[bidss[d]] = k_new.reshape(B, nb, block_size, KVl, D)
                vp[bidss[d]] = v_new.reshape(B, nb, block_size, KVl, D)
            x = A["post_attn"](rwl, swls, x, o_parts)
        return kpools, vpools, A["head_rows"](rw, sws, x, lens.long() - 1)

    return prefill


# ---------------------------------------------------------------------------
# Dense KV-cached decode: generate / generate_llama
# ---------------------------------------------------------------------------

_LAST_DECODE_STEPS: Optional[int] = None


def last_decode_steps() -> Optional[int]:
    """Trip count of the most recent ``generate``/``generate_llama`` decode
    loop in this process (None before the first call): below
    ``max_new_tokens`` when eos finished every row early; a beam search
    runs them all. A diagnostic, not thread-safe."""
    return _LAST_DECODE_STEPS


def top_k_top_p_filtering(logits, top_k=0, top_p=1.0):
    """Logits outside the top ``top_k`` and outside the smallest prefix of
    the sorted distribution whose mass reaches ``top_p`` set to -inf (the
    reference's ``top_k_top_p_filtering``; ties at the k-th value are
    kept)."""
    V = logits.shape[-1]
    if top_k and top_k > 0:
        k = min(int(top_k), V)  # top_k beyond the vocab keeps everything
        kth = torch.sort(logits, dim=-1).values[..., V - k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _prefill_dense(arch, params, ids, T0, T_max):
    """The prompt's forward: each layer's K/V copied into a zeroed dense
    cache (B, T_max, KV, D), and the last position's logits."""
    KV, D = arch["kv_heads"], arch["head_dim"]
    x = arch["embed_prompt"](params, ids, T0)
    caches = []
    for w in params["layers"]:
        x, (k, v) = arch["block"](w, x)
        kc = k.new_zeros((ids.shape[0], T_max, KV, D))
        vc = v.new_zeros((ids.shape[0], T_max, KV, D))
        kc[:, :T0] = k
        vc[:, :T0] = v
        caches.append((kc, vc))
    return caches, arch["head"](params, x)


def _forward_token(arch, params, caches, tok, pos):
    """One token a row at position ``pos`` through every layer against the
    dense caches (written in place); the next logits."""
    x = arch["embed_token"](params, tok, pos)
    for w, kv in zip(params["layers"], caches):
        x, _ = arch["block"](w, x, kv=kv, pos=pos)
    return arch["head"](params, x)


def _build_decode(arch, T0, T_max, max_new_tokens, temperature, top_k, top_p,
                  eos_token_id, do_sample):
    """The reference's one-program decode, run eagerly: prefill, then one
    token a row a step. The output's tail is pre-filled with eos, finished
    rows are frozen to eos, and the loop ends once every row is finished:
    with ``eos_token_id`` set each step reads ``finished.all()`` on the host
    (one sync a step, after the token is written and before the next
    forward is queued); without it the loop never syncs. The forward after
    the last token is skipped (the reference computes and drops it), which
    changes no output and no trip count."""

    def sample_from(logits, generator):
        if do_sample:
            logits = top_k_top_p_filtering(
                logits.float() / max(temperature, 1e-6), top_k, top_p)
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            return (logits - torch.log(-torch.log(u))).argmax(-1)
        return logits.argmax(-1)

    def decode(params, ids, generator):
        B = ids.shape[0]
        caches, logits = _prefill_dense(arch, params, ids, T0, T_max)
        fill = 0 if eos_token_id is None else int(eos_token_id)
        out = torch.full((B, T_max), fill, dtype=torch.int64,
                         device=ids.device)
        out[:, :T0] = ids
        finished = torch.zeros(B, dtype=torch.bool, device=ids.device)
        steps = 0
        while steps < max_new_tokens:
            nxt = sample_from(logits, generator)
            if eos_token_id is not None:
                # frozen rows re-write the eos their slot already holds
                nxt = torch.where(finished, eos_token_id, nxt)
                finished = finished | (nxt == eos_token_id)
            pos = T0 + steps
            out[:, pos] = nxt
            steps += 1
            if steps == max_new_tokens or (eos_token_id is not None
                                           and bool(finished.all())):
                break
            logits = _forward_token(arch, params, caches, nxt, pos)
        return out, steps

    return decode


def _stable_top_k(x, k):
    """``lax.top_k``: the k largest along the last axis, ties in index
    order (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _build_beam_decode(arch, T0, T_max, max_new_tokens, num_beams,
                       eos_token_id, length_penalty):
    """Beam search (the reference's ``_build_beam_decode``): the prompt's
    caches tiled across the K beams, beam 0 live first (the others start at
    -1e30, so step 1 draws K distinct tokens), the top K of K·V summed f32
    log-probs each step, rows (tokens and caches) re-gathered along the beam
    axis, finished beams extended by eos at no cost, and the best beam by
    the GNMT length penalty ``score / (T0 + max_new_tokens) **
    length_penalty``."""
    K = int(num_beams)

    def decode(params, ids):
        B = ids.shape[0]
        dev = ids.device
        caches, logits = _prefill_dense(arch, params, ids, T0, T_max)
        caches = [(kc.repeat_interleave(K, 0), vc.repeat_interleave(K, 0))
                  for kc, vc in caches]
        logits = logits.repeat_interleave(K, 0)  # (B*K, V)
        out = torch.zeros((B * K, T_max), dtype=torch.int64, device=dev)
        out[:, :T0] = ids.repeat_interleave(K, 0)
        scores = torch.tensor([0.0] + [-1e30] * (K - 1), device=dev).repeat(
            B, 1)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        base = (torch.arange(B, device=dev) * K)[:, None]
        for i in range(max_new_tokens):
            V = logits.shape[-1]
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            if eos_token_id is not None:
                eos_only = torch.full((V,), float("-inf"), device=dev)
                eos_only[eos_token_id] = 0.0
                logp = torch.where(finished[..., None], eos_only, logp)
            scores, idx = _stable_top_k(
                (scores[..., None] + logp).reshape(B, K * V), K)
            beam_idx, token = idx // V, idx % V
            rows = (beam_idx + base).reshape(-1)
            out = out[rows]
            caches = [(kc[rows], vc[rows]) for kc, vc in caches]
            finished = finished.gather(1, beam_idx)
            if eos_token_id is not None:
                finished = finished | (token == eos_token_id)
            pos = T0 + i
            out[:, pos] = token.reshape(-1)
            if i + 1 < max_new_tokens:  # the last forward's logits go unused
                logits = _forward_token(arch, params, caches,
                                        token.reshape(-1), pos)
        norm = scores / (float(T0 + max_new_tokens) ** float(length_penalty))
        best = norm.argmax(1)
        return out[best + base[:, 0]]

    return decode


def _run(arch, params, ids, T0, max_new_tokens, temperature, top_k, top_p,
         eos_token_id, do_sample, num_beams=1, length_penalty=0.0,
         generator=None):
    global _LAST_DECODE_STEPS
    T_max = T0 + int(max_new_tokens)
    if num_beams and int(num_beams) > 1:
        out = _build_beam_decode(arch, T0, T_max, int(max_new_tokens),
                                 int(num_beams), eos_token_id,
                                 float(length_penalty))(params, ids)
        _LAST_DECODE_STEPS = int(max_new_tokens)  # no early exit
        return out
    if generator is None and do_sample:
        from ..core import random as random_state

        generator = random_state.default_generator(ids.device)
    out, steps = _build_decode(
        arch, T0, T_max, int(max_new_tokens), float(temperature), int(top_k),
        float(top_p), eos_token_id, bool(do_sample))(params, ids, generator)
    _LAST_DECODE_STEPS = steps
    return out


def _prompt_ids(input_ids, device, max_pos, max_new_tokens):
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(device, torch.int64)
    if ids.dim() != 2:
        raise ValueError(f"generate: input_ids must be (B, T), got "
                         f"{tuple(ids.shape)}")
    T0 = ids.shape[1]
    if T0 + int(max_new_tokens) > max_pos:
        raise ValueError(f"generate: {T0 + int(max_new_tokens)} exceeds "
                         f"max_position_embeddings {max_pos}")
    return ids, T0


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens: int = 32,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, do_sample: bool = True,
             num_beams: int = 1, length_penalty: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Continuations of (B, T0) prompts for a ``GPTForPretraining``: (B, T0
    + max_new_tokens) int64 ids on the model's device (slots after a row's
    eos hold eos). Greedy (``do_sample=False``), sampled (temperature,
    top-k, top-p; uniforms from ``generator``, else the port's generator of
    the device, never torch's global one) or beam search
    (``num_beams > 1``)."""
    _, arch, params, max_pos = gpt_decode_state(model)
    ids, T0 = _prompt_ids(input_ids, params["wte"].device, max_pos,
                          max_new_tokens)
    return _run(arch, params, ids, T0, max_new_tokens, temperature, top_k,
                top_p, eos_token_id, do_sample, num_beams=num_beams,
                length_penalty=length_penalty, generator=generator)


@torch.inference_mode()
def generate_llama(model, input_ids, max_new_tokens=32, temperature=1.0,
                   top_k=0, top_p=1.0, eos_token_id=None, do_sample=True,
                   generator: Optional[torch.Generator] = None):
    """``generate`` for a ``LlamaForCausalLM``: RoPE at absolute cache
    positions, grouped-query attention against the un-repeated KV cache."""
    _, arch, params, max_pos = llama_decode_state(model)
    ids, T0 = _prompt_ids(input_ids, params["wte"].device, max_pos,
                          max_new_tokens)
    return _run(arch, params, ids, T0, max_new_tokens, temperature, top_k,
                top_p, eos_token_id, do_sample, generator=generator)
