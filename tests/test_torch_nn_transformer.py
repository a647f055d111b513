"""``paddle_tpu_torch.nn``'s transformer layers against the JAX package's,
with the reference's weights carried across by name (dropout 0): the
multi-head attention (self, cross, ``kdim``/``vdim``, bool and additive
masks, ``need_weights``, its ``Cache`` and ``StaticCache``), the encoder
and decoder layers (post- and pre-norm) and stacks, ``Transformer`` and
``generate_square_subsequent_mask``: outputs and the input and weight
gradients of a weighted sum of them. Then incremental decoding through
``gen_cache`` against full recomputation, and a small ``Transformer``
(2 + 2 layers, d_model 32) with a shared embedding trained one Adam step on
a label-smoothed soft-label cross entropy in both packages.

Tolerances: rtol 1e-4, atol 1e-5 (stacks of matmuls and layer norms).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from torch_nn_util import A, carry, check, check_layer
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(7)
B, S, T, E, NH = 2, 5, 4, 16, 4
SRC = _R.randn(B, S, E).astype(np.float32)
TGT = _R.randn(B, T, E).astype(np.float32)
CAUSAL = np.triu(np.full((T, T), -1e9, np.float32), 1)
KEEP = _R.rand(B, 1, T, S) > 0.3
KEEP[..., 0] = True

MHA = {
    "self": (dict(), (A(TGT),)),
    "cross": (dict(), (A(TGT), A(SRC), A(SRC))),
    "kdim_vdim": (dict(kdim=6, vdim=3),
                  (A(TGT), A(SRC[..., :6]), A(SRC[..., :3]))),
    "additive_mask": (dict(), (A(TGT), None, None, A(CAUSAL))),
    "bool_mask": (dict(), (A(TGT), A(SRC), A(SRC), A(KEEP))),
    "need_weights": (dict(need_weights=True), (A(TGT),)),
}


@pytest.mark.parametrize("case", sorted(MHA))
def test_multi_head_attention(case):
    kw, args = MHA[case]
    jl = jnn.MultiHeadAttention(E, NH, **kw)
    tl = tnn.MultiHeadAttention(E, NH, device="cpu", **kw)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    check_layer(jl, tl, args, rtol=1e-4, atol=1e-5, what=case)


def test_attention_caches():
    jl = jnn.MultiHeadAttention(E, NH)
    tl = carry(jl, tnn.MultiHeadAttention(E, NH, device="cpu"))

    def run(nn, layer, x, mem):
        static = layer.gen_cache(mem, mem, type=nn.MultiHeadAttention
                                 .StaticCache)
        cache = layer.gen_cache(x, type=nn.MultiHeadAttention.Cache)
        out1, cache = layer(x[:, :2], cache=cache)
        out2, cache = layer(x[:, 2:], cache=cache)
        out3, _ = layer(x, mem, mem, cache=static)
        return out1, out2, out3, cache.k, cache.v

    check(lambda x, m: run(jnn, jl, x, m), lambda x, m: run(tnn, tl, x, m),
          (A(TGT), A(SRC)), rtol=1e-4, atol=1e-5)


def _pair(build):
    return build(jnn, {}), build(tnn, {"device": "cpu"})


LAYERS = {
    "encoder_layer": (lambda m, kw: m.TransformerEncoderLayer(
        E, NH, 24, dropout=0.0, **kw), (A(SRC),)),
    "encoder_layer_prenorm_gelu_mask": (lambda m, kw: m.TransformerEncoderLayer(
        E, NH, 24, dropout=0.0, activation="gelu", normalize_before=True,
        **kw), (A(SRC), A(np.zeros((S, S), np.float32)))),
    "encoder": (lambda m, kw: m.TransformerEncoder(
        m.TransformerEncoderLayer(E, NH, 24, dropout=0.0, **kw), 2,
        m.LayerNorm(E, **kw)), (A(SRC),)),
    "decoder_layer": (lambda m, kw: m.TransformerDecoderLayer(
        E, NH, 24, dropout=0.0, **kw), (A(TGT), A(SRC), A(CAUSAL))),
    "decoder_layer_prenorm": (lambda m, kw: m.TransformerDecoderLayer(
        E, NH, 24, dropout=0.0, normalize_before=True, **kw),
        (A(TGT), A(SRC), A(CAUSAL), A(KEEP))),
    "decoder": (lambda m, kw: m.TransformerDecoder(
        m.TransformerDecoderLayer(E, NH, 24, dropout=0.0, **kw), 2),
        (A(TGT), A(SRC), A(CAUSAL))),
    "transformer": (lambda m, kw: m.Transformer(
        E, NH, 2, 2, 24, dropout=0.0, **kw),
        (A(SRC), A(TGT), None, A(CAUSAL))),
    "transformer_prenorm": (lambda m, kw: m.Transformer(
        E, NH, 1, 2, 24, dropout=0.0, normalize_before=True,
        activation="gelu", **kw), (A(SRC), A(TGT))),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    build, args = LAYERS[name]
    jl, tl = _pair(build)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    check_layer(jl, tl, args, rtol=1e-4, atol=1e-5, what=name)


def test_square_subsequent_mask():
    got = tnn.Transformer.generate_square_subsequent_mask(5)
    want = jnn.Transformer.generate_square_subsequent_mask(5)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_incremental_decoding_equals_full_recomputation():
    m = tnn.Transformer(E, NH, 2, 2, 24, dropout=0.0, device="cpu").eval()
    src = torch.tensor(SRC)
    memory = m.encoder(src)
    steps = torch.tensor(_R.randn(B, 6, E).astype(np.float32))
    cache = m.decoder.gen_cache(memory)
    inc = []
    for t in range(steps.shape[1]):
        out, cache = m.decoder(steps[:, t:t + 1], memory, cache=cache)
        inc.append(out)
    mask = tnn.Transformer.generate_square_subsequent_mask(steps.shape[1])
    full = m.decoder(steps, memory, mask)
    np.testing.assert_allclose(torch.cat(inc, 1).detach().numpy(),
                               full.detach().numpy(), rtol=1e-4, atol=1e-5)


V = 13


class _Seq2Seq:
    """A shared embedding (scaled by sqrt(d)), sinusoidal positions, the
    Transformer body and the tied output projection."""

    def __init__(self, m, **kw):
        self.emb = m.Embedding(V, 32, **kw)
        self.body = m.Transformer(32, 4, 2, 2, 64, dropout=0.0, **kw)
        pos = np.arange(16)[:, None] / np.power(
            10000, np.arange(0, 32, 2)[None] / 32)
        self.pe = np.concatenate([np.sin(pos), np.cos(pos)], 1).astype(
            np.float32)

    def params(self):
        return self.emb.parameters() + self.body.parameters()

    def loss(self, lib, F, src, tgt_in, tgt_out):
        to = paddle.to_tensor if lib is jnn else torch.tensor

        def embed(ids):
            return self.emb(ids) * 32 ** 0.5 + to(self.pe[: ids.shape[1]])

        mask = lib.Transformer.generate_square_subsequent_mask(
            tgt_in.shape[1])
        h = self.body(embed(src), embed(tgt_in), tgt_mask=mask)
        logits = F.linear(h, self.emb.weight.T if lib is tnn
                          else self.emb.weight.transpose([1, 0]))
        soft = F.label_smooth(F.one_hot(tgt_out, V), epsilon=0.1)
        return F.cross_entropy(logits, soft, soft_label=True)


def test_small_transformer_one_adam_step_with_label_smoothing():
    rng = np.random.RandomState(8)
    src = rng.randint(0, V, (3, 7)).astype(np.int64)
    tgt = rng.randint(0, V, (3, 6)).astype(np.int64)
    jm, tm = _Seq2Seq(jnn), _Seq2Seq(tnn, device="cpu")
    carry(jm.emb, tm.emb)
    carry(jm.body, tm.body)
    kw = dict(learning_rate=1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9)
    jo = paddle.optimizer.Adam(parameters=jm.params(), **kw)
    to = topt.Adam(parameters=tm.params(), **kw)
    losses = []
    for step in range(2):
        jl = jm.loss(jnn, JF, *(paddle.to_tensor(a) for a in
                                (src, tgt[:, :-1], tgt[:, 1:])))
        tl = tm.loss(tnn, TF, *(torch.tensor(a) for a in
                                (src, tgt[:, :-1], tgt[:, 1:])))
        jl.backward()
        tl.backward()
        if step == 0:  # Adam's first step is about lr * sign(g): later
            # gradients differ where a tiny one changed sign
            jg = np.asarray(jm.emb.weight.grad.numpy())
            np.testing.assert_allclose(tm.emb.weight.grad.numpy(), jg,
                                       rtol=1e-4, atol=1e-5)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        losses.append((float(tl), float(jl.numpy())))
    np.testing.assert_allclose(losses[0][0], losses[0][1], rtol=1e-5)
    np.testing.assert_allclose(losses[1][0], losses[1][1], rtol=1e-4)
    assert losses[1][0] < losses[0][0]
