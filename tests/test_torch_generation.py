"""Port parity: the dense KV-cached decode of ``paddle_tpu_torch.models.
generation`` (``generate``, ``generate_llama``, beam search,
``top_k_top_p_filtering``, ``last_decode_steps``) against the reference's
``paddle_tpu.models.generation``.

Tiny GPT and Llama models (f32, dropout 0, the reference's weights loaded
by name) decode the same prompts (numpy, from a seed) in both packages:
greedy and beam tokens must be equal, exactly (f32 makes ties rare, and the
port's beam top-k orders ties by index, as ``lax.top_k`` does);
``top_k_top_p_filtering`` must be equal bit for bit. Sampled calls cannot
match JAX's threefry draws, so they are held to being well formed and to
drawing only among the top-k logits. The reference's own oracle
(``tests/test_serving.py``: the engine's greedy tokens equal the dense
``generate``) holds for the port's engine and dense decode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import generation as tgen
from torch_port_util import port_of, port_of_llama

SMALL = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=64)
B, T0, NEW = 3, 7, 6


def _gpt():
    paddle.seed(11)
    jm = JGPT(JGPTConfig(**SMALL, hidden_dropout=0.0,
                         attention_dropout=0.0))
    jm.eval()
    return jm, port_of(jm)


def _llama(kv):
    paddle.seed(12)
    jm = JLlama(JLlamaConfig(**SMALL, num_kv_heads=kv))
    return jm, port_of_llama(jm)


MODELS = {"gpt": _gpt, "llama": lambda: _llama(None),
          "llama_gqa": lambda: _llama(2)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    return (request.param,) + MODELS[request.param]()


def _prompts(seed=0, b=B, t=T0):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"],
                                               (b, t)).astype(np.int64)


def _ref_decode(name, jm, ids, **kw):
    """The reference's decode: ``generate``/``generate_llama``, or its
    ``_run`` for a Llama beam search (its ``generate_llama`` takes no
    ``num_beams``)."""
    ids_j = paddle.to_tensor(ids)
    if name == "gpt":
        out = jgen.generate(jm, ids_j, **kw)
    elif kw.get("num_beams", 1) > 1:
        key, arch, params, _ = jgen.llama_decode_state(jm)
        kw = {"temperature": 1.0, "top_k": 0, "top_p": 1.0,
              "eos_token_id": None, "do_sample": False, **kw}
        out = jgen._run(key, arch, params, jnp.asarray(ids, jnp.int32),
                        ids.shape[1], **kw)
    else:
        out = jgen.generate_llama(jm, ids_j, **kw)
    return np.asarray(out.numpy()).astype(np.int64)


def _port_decode(name, tm, ids, **kw):
    if name == "gpt":
        return tgen.generate(tm, ids, **kw).numpy()
    if kw.get("num_beams", 1) > 1:
        _, arch, params, _ = tgen.llama_decode_state(tm)
        kw = {"temperature": 1.0, "top_k": 0, "top_p": 1.0,
              "eos_token_id": None, "do_sample": False, **kw}
        with torch.inference_mode():
            return tgen._run(arch, params, torch.from_numpy(ids),
                             ids.shape[1], **kw).numpy()
    return tgen.generate_llama(tm, ids, **kw).numpy()


def test_greedy_tokens_match(pair):
    name, jm, tm = pair
    ids = _prompts()
    want = _ref_decode(name, jm, ids, max_new_tokens=NEW, do_sample=False)
    got = _port_decode(name, tm, ids, max_new_tokens=NEW, do_sample=False)
    np.testing.assert_array_equal(got, want)
    assert tgen.last_decode_steps() == jgen.last_decode_steps() == NEW


@pytest.mark.parametrize("rows", ["one_row_stops_early", "rows_frozen"])
def test_eos_stops_and_freezes_as_reference(pair, rows):
    """eos = a token row 0 emits at its third step: one prompt stops there
    (fewer steps than max_new_tokens); in a batch the finished row is
    frozen to eos while the others run on."""
    name, jm, tm = pair
    ids = _prompts(seed=1)[:1] if rows == "one_row_stops_early" \
        else _prompts(seed=1)
    free = _port_decode(name, tm, ids, max_new_tokens=NEW, do_sample=False)
    eos = int(free[0, T0 + 2])
    kw = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=eos)
    want = _ref_decode(name, jm, ids, **kw)
    want_steps = jgen.last_decode_steps()
    got = _port_decode(name, tm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    assert tgen.last_decode_steps() == want_steps
    first = list(free[0, T0:]).index(eos)
    assert (got[0, T0 + first:] == eos).all()
    if rows == "one_row_stops_early":
        assert want_steps == first + 1 < NEW


@pytest.mark.parametrize("beams,penalty,eos", [(2, 0.0, False),
                                               (4, 0.0, False),
                                               (4, 1.0, True)],
                         ids=["k2", "k4", "k4_penalty_eos"])
def test_beam_tokens_match(pair, beams, penalty, eos):
    name, jm, tm = pair
    ids = _prompts(seed=2)
    kw = dict(max_new_tokens=NEW, num_beams=beams, length_penalty=penalty)
    if eos:
        free = _port_decode(name, tm, ids, max_new_tokens=NEW,
                            do_sample=False)
        kw["eos_token_id"] = int(free[1, T0 + 1])
    want = _ref_decode(name, jm, ids, **kw)
    got = _port_decode(name, tm, ids, **kw)
    assert got.shape == (B, T0 + NEW)
    np.testing.assert_array_equal(got, want)
    assert tgen.last_decode_steps() == NEW


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6),
                                         (10 ** 6, 0.95)],
                         ids=["k5", "p0.8", "k7_p0.6", "k_over_vocab"])
def test_top_k_top_p_filtering_is_exact(top_k, top_p):
    logits = np.random.RandomState(3).randn(4, 53).astype(np.float32)
    want = np.asarray(jgen.top_k_top_p_filtering(jnp.asarray(logits), top_k,
                                                 top_p))
    got = tgen.top_k_top_p_filtering(torch.from_numpy(logits), top_k,
                                     top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_calls_are_well_formed_and_inside_the_top_k(pair):
    name, _, tm = pair
    ids = _prompts(seed=4)
    g = torch.Generator().manual_seed(0)
    k = 5
    out = _port_decode(name, tm, ids, max_new_tokens=NEW, do_sample=True,
                       top_k=k, top_p=0.9, temperature=0.8, generator=g)
    assert out.shape == (B, T0 + NEW)
    np.testing.assert_array_equal(out[:, :T0], ids)
    assert ((out >= 0) & (out < SMALL["vocab_size"])).all()
    with torch.no_grad():
        logits = tm(torch.from_numpy(out))
        logits = logits[0] if isinstance(logits, tuple) else logits
    for j in range(NEW):
        top = logits[:, T0 + j - 1].topk(k).indices.numpy()
        assert all(out[r, T0 + j] in top[r] for r in range(B)), j
    again = _port_decode(name, tm, ids, max_new_tokens=NEW, do_sample=True,
                         top_k=k, top_p=0.9, temperature=0.8,
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, out)


def test_engine_greedy_equals_dense_generate(pair):
    """The reference's oracle (``tests/test_serving.py``
    ``test_matches_dense_generate_greedy``), on the port alone."""
    from paddle_tpu_torch.serving import Engine

    name, _, tm = pair
    ids = _prompts(seed=5)
    with Engine(tm, device="cpu", block_size=8, num_blocks=64, max_batch=8,
                max_seq_len=64) as eng:
        handles = [eng.submit(p.tolist(), max_new_tokens=NEW) for p in ids]
        served = [h.result(timeout=300) for h in handles]
    dense = _port_decode(name, tm, ids, max_new_tokens=NEW, do_sample=False)
    assert served == dense.tolist()


def test_generate_checks_the_length():
    _, tm = _gpt()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(_prompts(t=60), max_new_tokens=10)
