"""FasterTokenizer — text → padded id tensors inside the framework (port of
``paddle_tpu/text/faster_tokenizer.py``).

Reference: ``paddle/fluid/operators/string/faster_tokenizer_op.cc`` (native
BERT BasicTokenizer + WordPiece op feeding ERNIE/BERT serving graphs).
Tokenization is host-side string work, so it stays native: the port's own
``core/csrc/tokenizer.cc`` behind ctypes, built with the rest of the native
runtime at first use. A build or load failure raises (``core/native.py``).

The pure-Python twin (``_basic_tokenize``, ``_wordpiece``) serves only
where the reference's rule sends a vocab to it: when the vocab's ids are
not exactly 0..N-1, which the native loader (ids by line number) cannot
hold. ``is_native`` says which backend a tokenizer took. The two backends
differ on Unicode whitespace, as the reference's do: the twin's
``str.split()`` splits on every ``str.isspace()`` code point, the C++ only
on space, tab, newline and carriage return (the others are punctuation in
U+2000–U+206F and U+3000–U+303F, or kept in a word). Each keeps its rule.

Output: ``input_ids`` and ``token_type_ids`` as int64 tensors padded to
``max_seq_len``, on the caller's device (the card unless the CPU was asked
for).
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.place import resolve_device
from ..nn.layer.layers import Layer

__all__ = ["FasterTokenizer"]


# -- the pure-python twin (the reference's, as it is) -------------------------

def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_punct(cp: int) -> bool:
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return (0x2000 <= cp <= 0x206F or 0x3000 <= cp <= 0x303F
            or 0xFF00 <= cp <= 0xFF0F or 0xFF1A <= cp <= 0xFF20
            or 0xFF3B <= cp <= 0xFF40 or 0xFF5B <= cp <= 0xFF65)


def _basic_tokenize(text: str, lower: bool) -> List[str]:
    out = []
    for ch in text:
        cp = ord(ch)
        # the C++ side's control-char rule (ASCII controls only)
        if cp == 0 or cp == 0xFFFD or (
                (cp < 0x20 or cp == 0x7F) and ch not in "\t\n\r"):
            continue
        if ch in " \t\n\r":
            out.append(" ")
            continue
        if lower and "A" <= ch <= "Z":
            ch = ch.lower()
            cp = ord(ch)
        if _is_cjk(cp) or _is_punct(cp):
            out.append(f" {ch} ")
            continue
        out.append(ch)
    return "".join(out).split()


def _wordpiece(word: str, vocab: Dict[str, int], unk: int) -> List[int]:
    if len(word.encode("utf-8")) > 100:
        return [unk]
    pieces: List[int] = []
    start = 0
    b = word
    while start < len(b):
        end = len(b)
        cur = -1
        while end > start:
            sub = b[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = vocab[sub]
                break
            end -= 1
        if cur < 0:
            return [unk]
        pieces.append(cur)
        start = end
    return pieces


class FasterTokenizer(Layer):
    """BERT-style tokenizer layer: list-of-strings → (input_ids,
    token_type_ids) int64 tensors padded to ``max_seq_len``.

    ``vocab`` is a token→id dict or a vocab-file path (one token per line,
    id = line number; the first of duplicated lines wins, as in the C++
    loader). ``device`` is where the ids go (default: ``set_device``'s
    choice, else the card)."""

    def __init__(self, vocab: Union[str, Dict[str, int]], do_lower_case=True,
                 device=None):
        super().__init__()
        self.do_lower_case = bool(do_lower_case)
        self._device = device
        if isinstance(vocab, str):
            self._vocab_path = vocab
            self.vocab = {}
            with open(vocab, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    self.vocab.setdefault(line.rstrip("\r\n"), i)
        else:
            self.vocab = dict(vocab)
            self._vocab_path = None
        for tok in ("[UNK]", "[CLS]", "[SEP]", "[PAD]"):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing the special token {tok}")
        self._unk = self.vocab["[UNK]"]
        self._cls = self.vocab["[CLS]"]
        self._sep = self.vocab["[SEP]"]
        self._pad = self.vocab["[PAD]"]
        self._native = None
        self._handle = None
        self._tmp_vocab = None
        # the native loader assigns ids by line number, so it serves only
        # a dense vocab (ids exactly 0..N-1); any other takes the twin
        dense = sorted(self.vocab.values()) == list(range(len(self.vocab)))
        if dense:
            from ..core.native import lib

            L = lib()
            path = self._vocab_path
            if path is None:
                fd, path = tempfile.mkstemp(suffix=".vocab")
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    for tok, _ in sorted(self.vocab.items(),
                                         key=lambda kv: kv[1]):
                        f.write(tok + "\n")
                self._tmp_vocab = path  # unlinked in __del__
            h = L.ptk_create(path.encode(), 1 if self.do_lower_case else 0)
            if not h:
                raise RuntimeError(f"tokenizer.cc could not read {path!r}")
            self._native, self._handle = L, h
        self.is_native = self._handle is not None

    def __del__(self):
        try:
            if self._handle:
                self._native.ptk_destroy(self._handle)
            if getattr(self, "_tmp_vocab", None):
                os.unlink(self._tmp_vocab)
        except Exception:
            pass

    def _encode_one(self, text: str) -> List[int]:
        # C strings stop at NUL; the twin cuts there too, so the backends
        # cannot differ on embedded NULs
        if "\x00" in text:
            text = text.split("\x00", 1)[0]
        if self._handle:
            # every id takes at least one code point
            buf = np.empty(max(16, 2 * len(text) + 8), np.int64)
            n = self._native.ptk_encode(self._handle, text.encode(),
                                        buf.ctypes.data, buf.size)
            return buf[:n].tolist()
        ids: List[int] = []
        for w in _basic_tokenize(text, self.do_lower_case):
            ids.extend(_wordpiece(w, self.vocab, self._unk))
        return ids

    def forward(self, text: Union[str, Sequence[str]],
                text_pair: Optional[Union[str, Sequence[str]]] = None,
                max_seq_len: int = 128, pad_to_max_seq_len: bool = True):
        texts = [text] if isinstance(text, str) else list(text)
        pairs = None
        if text_pair is not None:
            pairs = [text_pair] if isinstance(text_pair, str) \
                else list(text_pair)
            if len(pairs) != len(texts):
                raise ValueError("text and text_pair must have equal lengths")
        rows, segs = [], []
        for i, t in enumerate(texts):
            a = self._encode_one(t)
            b = self._encode_one(pairs[i]) if pairs else []
            # [CLS] a [SEP] (+ b [SEP]); truncate a-then-b to fit
            budget = max_seq_len - 2 - (1 if b else 0)
            if budget < 1:
                raise ValueError(
                    f"max_seq_len={max_seq_len} leaves no room for content "
                    "after the special tokens")
            if b:
                # longest-first truncation (reference truncate_seq_pair)
                while len(a) + len(b) > budget:
                    (a if len(a) >= len(b) else b).pop()
            else:
                a = a[:budget]
            ids = [self._cls] + a + [self._sep]
            seg = [0] * len(ids)
            if b:
                ids += b + [self._sep]
                seg += [1] * (len(b) + 1)
            if pad_to_max_seq_len:
                ids += [self._pad] * (max_seq_len - len(ids))
                seg += [0] * (max_seq_len - len(seg))
            rows.append(ids)
            segs.append(seg)
        if not pad_to_max_seq_len:
            width = max(len(r) for r in rows)
            rows = [r + [self._pad] * (width - len(r)) for r in rows]
            segs = [s + [0] * (width - len(s)) for s in segs]
        dev = resolve_device(self._device)
        return (torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
                torch.from_numpy(np.asarray(segs, np.int64)).to(dev))
