"""The port's ``text`` against the reference's: ``FasterTokenizer`` on the
port's own ``tokenizer.cc`` and its Python twin, ``viterbi_decode`` and
the text datasets.

The reference's two backends differ on Unicode whitespace (its C++ splits
on space, tab, newline and CR only; its twin on every ``str.isspace()``
code point). The port keeps each backend's rule: its native ids equal the
reference's native ids, its twin's equal the reference twin's, and the
four pinned cases below hold both behaviours.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (x64 on, before the reference's modules)
from paddle_tpu import text as jtext
from paddle_tpu.text import faster_tokenizer as jft

import paddle_tpu_torch as tp
from paddle_tpu_torch import text as ptext
from paddle_tpu_torch.text import faster_tokenizer as pft
from torch_port_util import cpu_device

# code points on which the reference's two backends split differently
DIVERGENT_WS = ("\u3000", "\u2003", "\xa0", "\x85")
_CJK = [chr(0x4E00 + i) for i in range(40)]
_PUNCT = list(",.!?;:'\"()-") + ["\u3001", "\u3002", "\uff0c", "\u2014"]
_ACCENTED = ["café", "naïve", "über", "señor", "résumé", "ÉCOLE"]


def _letters(rng, lo, hi):
    return "".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(lo, hi)))


def make_vocab(seed=0, n_words=300):
    """A dense WordPiece vocab: the special tokens, ASCII words, ``##``
    continuations, CJK characters, punctuation and accented words."""
    rng = np.random.RandomState(seed)
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    words = sorted({_letters(rng, 2, 7) for _ in range(n_words)})
    toks += words
    toks += sorted({"##" + _letters(rng, 1, 4) for _ in range(n_words // 2)})
    toks += _CJK[:30] + _PUNCT + [w.lower() for w in _ACCENTED[:4]]
    return {t: i for i, t in enumerate(dict.fromkeys(toks))}, words


def make_text(rng, words, n=40, divergent=False):
    """Seeded text: words (cased, joined, unknown), CJK, accents,
    punctuation, ASCII controls, tabs and newlines, now and then a NUL or a
    word over 100 bytes; with ``divergent``, the code points the reference's
    backends split differently."""
    parts = []
    for _ in range(n):
        k = rng.randint(0, 12)
        if k <= 3:
            w = words[rng.randint(len(words))]
            parts.append(w.upper() if k == 0 else w)
        elif k == 4:
            parts.append(words[rng.randint(len(words))]
                         + _letters(rng, 1, 4))
        elif k == 5:
            parts.append("".join(_CJK[i] for i in rng.randint(0, 40, 3)))
        elif k == 6:
            parts.append(_ACCENTED[rng.randint(len(_ACCENTED))])
        elif k == 7:
            parts.append(_PUNCT[rng.randint(len(_PUNCT))])
        elif k == 8:
            parts.append(chr(int(rng.choice([1, 7, 27, 127]))) + "x")
        elif k == 9:
            parts.append(rng.choice(["\t", "\n", "\r\n"]))
        elif k == 10 and rng.rand() < 0.3:
            parts.append("a" * 120 if rng.rand() < 0.5 else "\x00tail")
        else:
            parts.append(_letters(rng, 1, 9))
        if divergent and rng.rand() < 0.3:
            parts.append(DIVERGENT_WS[rng.randint(4)])
    return " ".join(parts)


VOCAB, WORDS = make_vocab()


def _port(vocab=VOCAB, lower=True):
    return pft.FasterTokenizer(vocab, do_lower_case=lower, device="cpu")


def _ids(out):
    return [np.asarray(o.numpy() if hasattr(o, "numpy") else o)
            for o in out]


@pytest.fixture(scope="module")
def ref_native():
    tok = jft.FasterTokenizer(VOCAB)
    if not tok.is_native:
        pytest.skip("the reference's runtime_cpp library did not load")
    return tok


@pytest.mark.parametrize("seed", range(12))
def test_native_ids_equal_the_reference_native(seed, ref_native):
    rng = np.random.RandomState(100 + seed)
    tok = _port()
    assert tok.is_native
    texts = [make_text(rng, WORDS, divergent=seed % 2 == 1)
             for _ in range(4)]
    for t in texts:
        assert tok._encode_one(t) == ref_native._encode_one(t)
    got = _ids(tok(texts, max_seq_len=64))
    want = _ids(ref_native(texts, max_seq_len=64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_len,pad", [(16, True), (48, True), (48, False),
                                         (300, False)])
def test_pairs_truncation_and_padding_equal_the_reference(max_len, pad,
                                                          ref_native):
    rng = np.random.RandomState(max_len)
    a = [make_text(rng, WORDS, n=int(rng.randint(3, 60))) for _ in range(5)]
    b = [make_text(rng, WORDS, n=int(rng.randint(3, 60))) for _ in range(5)]
    got = _ids(_port()(a, b, max_seq_len=max_len, pad_to_max_seq_len=pad))
    want = _ids(ref_native(a, b, max_seq_len=max_len,
                           pad_to_max_seq_len=pad))
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("lower", [True, False])
def test_twin_equals_the_reference_twin(seed, lower):
    """Everywhere, the divergent whitespace included."""
    rng = np.random.RandomState(200 + seed)
    for _ in range(4):
        t = make_text(rng, WORDS, divergent=True)
        bt = pft._basic_tokenize(t, lower)
        assert bt == jft._basic_tokenize(t, lower)
        for w in bt:
            assert pft._wordpiece(w, VOCAB, 1) == jft._wordpiece(w, VOCAB, 1)
    tok, ref = _port(lower=lower), jft.FasterTokenizer(VOCAB, lower)
    tok._handle = ref._handle = None  # both twins
    texts = [make_text(rng, WORDS, divergent=True) for _ in range(3)]
    for g, w in zip(_ids(tok(texts, max_seq_len=80)),
                    _ids(ref(texts, max_seq_len=80))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_native_equals_the_twin_without_the_divergent_whitespace(seed):
    rng = np.random.RandomState(300 + seed)
    tok, twin = _port(), _port()
    twin._handle = None
    for _ in range(4):
        t = make_text(rng, WORDS)
        assert tok._encode_one(t) == twin._encode_one(t)


PIN_VOCAB = {t: i for i, t in enumerate(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "b", "\u3000", "\xa0",
     "\u2003"])}
# text -> (native ids, twin ids), the same in both packages
PINNED = {
    "a\u3000b": ([4, 6, 5], [4, 5]),
    "a\u2003b": ([4, 8, 5], [4, 5]),
    "a\xa0b": ([1], [4, 5]),
    "a\x85b": ([1], [4, 5]),
}


@pytest.mark.parametrize("text", sorted(PINNED))
def test_the_pinned_whitespace_cases(text):
    native, twin = PINNED[text]
    for mod, kw in ((pft, {"device": "cpu"}), (jft, {})):
        tok = mod.FasterTokenizer(PIN_VOCAB, **kw)
        assert tok.is_native
        assert tok._encode_one(text) == native, mod.__name__
        tok._handle = None
        assert tok._encode_one(text) == twin, mod.__name__


def test_a_sparse_vocab_takes_the_twin_in_both():
    sparse = {t: 2 * i for i, t in enumerate(VOCAB)}
    tok, ref = pft.FasterTokenizer(sparse, device="cpu"), \
        jft.FasterTokenizer(sparse)
    assert not tok.is_native and not ref.is_native
    rng = np.random.RandomState(7)
    texts = [make_text(rng, WORDS, divergent=True) for _ in range(3)]
    for g, w in zip(_ids(tok(texts, max_seq_len=50)),
                    _ids(ref(texts, max_seq_len=50))):
        np.testing.assert_array_equal(g, w)


def test_vocab_file_first_duplicate_wins_and_errors(tmp_path):
    path = tmp_path / "v.txt"
    toks = list(PIN_VOCAB) + ["a", "zz"]
    path.write_text("\n".join(toks) + "\n", encoding="utf-8")
    tok, ref = pft.FasterTokenizer(str(path), device="cpu"), \
        jft.FasterTokenizer(str(path))
    assert tok.vocab == ref.vocab and tok.vocab["a"] == 4
    assert tok._encode_one("a zz\x00 b") == ref._encode_one("a zz\x00 b")
    with pytest.raises(ValueError):
        tok(["a"], max_seq_len=2)
    with pytest.raises(ValueError):
        pft.FasterTokenizer({"[PAD]": 0}, device="cpu")
    with pytest.raises(ValueError):
        tok(["a", "b"], ["a"])


def test_ids_land_on_the_callers_device():
    with cpu_device():
        ids, seg = pft.FasterTokenizer(PIN_VOCAB)(["a b"], max_seq_len=8)
    assert ids.device.type == "cpu" and ids.dtype == torch.int64
    assert ids.tolist() == [[2, 4, 5, 3, 0, 0, 0, 0]]
    assert seg.tolist() == [[0] * 8]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pft.FasterTokenizer(PIN_VOCAB)(["a"])


def test_a_native_build_failure_raises(monkeypatch):
    from paddle_tpu_torch.core import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", lambda: (_ for _ in ()).throw(
        RuntimeError("native runtime build failed")))
    with pytest.raises(RuntimeError, match="build failed"):
        pft.FasterTokenizer(PIN_VOCAB, device="cpu")


# -- viterbi_decode -----------------------------------------------------------
def _viterbi_inputs(seed=0):
    rng = np.random.RandomState(seed)
    emis = rng.randn(4, 9, 5).astype(np.float32)
    trans = rng.randn(7, 7).astype(np.float32)
    lens = np.array([9, 5, 1, 7], np.int64)
    return emis, trans, lens


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_equals_the_reference(seed, bos_eos):
    emis, trans, lens = _viterbi_inputs(seed)
    js, jp = jtext.viterbi_decode(paddle_tpu.to_tensor(emis),
                                  paddle_tpu.to_tensor(trans),
                                  paddle_tpu.to_tensor(lens), bos_eos)
    ps, pp = ptext.viterbi_decode(torch.from_numpy(emis),
                                  torch.from_numpy(trans),
                                  torch.from_numpy(lens), bos_eos)
    assert pp.dtype == torch.int64 and tuple(pp.shape) == (4, 9)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp.numpy()))
    want = np.asarray(js.numpy())
    np.testing.assert_allclose(ps.numpy(), want, rtol=1e-6, atol=0)
    dec = ptext.ViterbiDecoder(torch.from_numpy(trans), bos_eos)
    s2, p2 = dec(torch.from_numpy(emis), torch.from_numpy(lens))
    assert torch.equal(p2, pp) and torch.equal(s2, ps)


def _brute(emis, trans, length, bos_eos):
    N = emis.shape[1]
    best, bp = -np.inf, None
    for seq in itertools.product(range(N), repeat=length):
        s = emis[0, seq[0]] + (trans[-2, seq[0]] if bos_eos else 0.0)
        for k in range(1, length):
            s += trans[seq[k - 1], seq[k]] + emis[k, seq[k]]
        if bos_eos:
            s += trans[seq[-1], -1]
        if s > best:
            best, bp = s, seq
    return best, list(bp)


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_against_brute_force(bos_eos):
    rng = np.random.RandomState(3)
    emis = rng.randn(3, 5, 3).astype(np.float32)
    trans = rng.randn(5, 5).astype(np.float32)
    lens = np.array([5, 3, 1])
    sc, path = ptext.viterbi_decode(torch.from_numpy(emis),
                                    torch.from_numpy(trans),
                                    torch.from_numpy(lens), bos_eos)
    for b, L in enumerate(lens):
        best, bp = _brute(emis[b].astype(np.float64),
                          trans.astype(np.float64), int(L), bos_eos)
        assert abs(best - float(sc[b])) < 1e-4
        got = path[b].tolist()
        assert got[:L] == bp and set(got[L - 1:]) == {bp[-1]}


def test_viterbi_needs_no_gradient_and_keeps_the_device():
    emis, trans, lens = _viterbi_inputs()
    e = torch.from_numpy(emis).requires_grad_(True)
    s, p = ptext.viterbi_decode(e, torch.from_numpy(trans),
                                torch.from_numpy(lens))
    assert not s.requires_grad and s.device.type == "cpu"
    with cpu_device():
        s2, p2 = ptext.viterbi_decode(emis, trans, lens)
    assert torch.equal(p2, p) and torch.equal(s2, s.detach())


# -- datasets -----------------------------------------------------------------
DATASETS = [
    ("Imdb", {}), ("Imdb", {"cutoff": 4000}), ("Imikolov", {}),
    ("Imikolov", {"data_type": "SEQ"}), ("UCIHousing", {}),
    ("Conll05st", {}), ("Movielens", {}), ("WMT14", {}), ("WMT16", {}),
]


def _flat(sample):
    if isinstance(sample, (tuple, list)):
        return [a for s in sample for a in _flat(s)]
    return [np.asarray(sample)]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name,kw", DATASETS,
                         ids=[f"{n}{'-' + '-'.join(k) if k else ''}"
                              for n, k in DATASETS])
def test_datasets_bit_equal(name, kw, mode, monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    ref = getattr(jtext, name)(mode=mode, **kw)
    port = getattr(ptext, name)(mode=mode, **kw)
    assert len(port) == len(ref)
    for i in (0, len(ref) // 2, len(ref) - 1):
        got, want = _flat(port[i]), _flat(ref[i])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_uci_housing_reads_the_local_file(monkeypatch, tmp_path):
    d = tmp_path / "uci_housing"
    d.mkdir()
    rows = np.random.RandomState(1).rand(20, 14).astype(np.float32)
    np.savetxt(d / "housing.data", rows)
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    ref, port = jtext.UCIHousing(mode="test"), ptext.UCIHousing(mode="test")
    assert len(port) == len(ref) == 4
    np.testing.assert_array_equal(port.data, ref.data)


def test_the_registry_holds_viterbi():
    from paddle_tpu_torch.ops import registry

    assert registry.MISSING_MODULES == ()
    assert registry.all_ops()["text.viterbi_decode"] is tp.text.viterbi_decode
