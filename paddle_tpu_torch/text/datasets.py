"""Text datasets (port of ``paddle_tpu/text/datasets.py``; reference
python/paddle/text/datasets/ — Imdb, Imikolov,
UCIHousing, Conll05st, Movielens, WMT14, WMT16).

Zero-egress environment: UCIHousing loads ``housing.data`` from the shared
dataset cache (``paddle.io.data_home()``, override with
``PADDLE_TPU_DATA_HOME``) when present; all other datasets generate a
deterministic synthetic corpus with the reference record shapes/vocab
structure so text pipelines run end-to-end without downloads.
"""
from __future__ import annotations

import os

import numpy as np

from ..io import Dataset, data_home


class Imdb(Dataset):
    """Sentiment classification: (token_ids int64[seq], label {0,1}).
    ``cutoff`` is the word-frequency cutoff (reference semantics): it bounds
    the synthetic vocabulary, not the document length."""

    VOCAB = 5000

    def __init__(self, data_file=None, mode="train", cutoff=150, download=True):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 512 if mode == "train" else 128
        vocab = max(64, self.VOCAB - int(cutoff))  # higher cutoff -> smaller vocab
        self.docs = []
        self.labels = []
        for _ in range(n):
            length = int(rng.randint(20, 150))
            label = int(rng.randint(0, 2))
            # label-correlated token distribution so models can actually learn
            bias = 0 if label == 0 else vocab // 2
            toks = rng.randint(bias, bias + vocab // 2, length)
            self.docs.append(toks.astype(np.int64))
            self.labels.append(np.int64(label))
        self.word_idx = {f"w{i}": i for i in range(vocab)}

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """LM dataset. data_type='NGRAM': fixed window_size tuples;
    data_type='SEQ': variable-length token sequences (reference semantics)."""

    VOCAB = 2000

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=True):
        rng = np.random.RandomState(2 if mode == "train" else 3)
        n = 2048 if mode == "train" else 256
        vocab = max(64, self.VOCAB - int(min_word_freq))
        self.data_type = data_type
        self.window_size = window_size
        if data_type == "SEQ":
            self.data = [
                rng.randint(0, vocab, int(rng.randint(5, 40))).astype(np.int64)
                for _ in range(n)
            ]
        else:
            self.data = list(rng.randint(0, vocab, (n, window_size)).astype(np.int64))
        self.word_idx = {f"w{i}": i for i in range(vocab)}

    def __getitem__(self, idx):
        row = self.data[idx]
        return row if self.data_type == "SEQ" else tuple(row)

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """Regression: (13 standardized float features, raw target).
    Reference semantics: features are normalized, the target is not."""

    def __init__(self, data_file=None, mode="train", download=True):
        path = os.path.join(data_home(), "uci_housing", "housing.data")
        if os.path.exists(path):
            raw = np.loadtxt(path).astype(np.float32)
        else:
            rng = np.random.RandomState(4)
            X = rng.rand(506, 13).astype(np.float32)
            w = rng.rand(13, 1).astype(np.float32)
            y = X @ w + 0.1 * rng.randn(506, 1).astype(np.float32)
            raw = np.concatenate([X, y], axis=1)
        feats, target = raw[:, :-1], raw[:, -1:]
        mean, std = feats.mean(axis=0), feats.std(axis=0) + 1e-8
        feats = (feats - mean) / std
        data = np.concatenate([feats, target], axis=1)
        split = int(len(data) * 0.8)
        self.data = data[:split] if mode == "train" else data[split:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """SRL: (word_ids, predicate, label_ids) per token."""

    WORD_VOCAB, LABEL_VOCAB = 3000, 60

    def __init__(self, data_file=None, word_dict_file=None, verb_dict_file=None,
                 target_dict_file=None, emb_file=None, mode="train", download=True):
        rng = np.random.RandomState(5 if mode == "train" else 6)
        n = 256 if mode == "train" else 64
        self.samples = []
        for _ in range(n):
            length = int(rng.randint(5, 40))
            words = rng.randint(0, self.WORD_VOCAB, length).astype(np.int64)
            pred = rng.randint(0, self.WORD_VOCAB, length).astype(np.int64)
            labels = rng.randint(0, self.LABEL_VOCAB, length).astype(np.int64)
            self.samples.append((words, pred, labels))

    def get_dict(self):
        return (
            {f"w{i}": i for i in range(self.WORD_VOCAB)},
            {f"v{i}": i for i in range(200)},
            {f"l{i}": i for i in range(self.LABEL_VOCAB)},
        )

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """Rating prediction: (user feats, movie feats, rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1, rand_seed=0, download=True):
        rng = np.random.RandomState(7 if mode == "train" else 8)
        n = 1024 if mode == "train" else 128
        self.rows = [
            (
                np.int64(rng.randint(0, 6040)),    # user id
                np.int64(rng.randint(0, 2)),       # gender
                np.int64(rng.randint(0, 7)),       # age bucket
                np.int64(rng.randint(0, 21)),      # occupation
                np.int64(rng.randint(0, 3952)),    # movie id
                rng.randint(0, 19, 3).astype(np.int64),  # categories
                np.float32(rng.randint(1, 6)),     # rating
            )
            for _ in range(n)
        ]

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class _WMTBase(Dataset):
    """Synthetic translation pairs: (src_ids, trg_ids, trg_next_ids)."""

    def __init__(self, seed, src_vocab, trg_vocab, mode="train"):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = 512 if mode == "train" else 64
        self.src_vocab, self.trg_vocab = src_vocab, trg_vocab
        self.pairs = []
        for _ in range(n):
            ls = int(rng.randint(4, 30))
            lt = int(rng.randint(4, 30))
            src = rng.randint(2, src_vocab, ls).astype(np.int64)
            trg = rng.randint(2, trg_vocab, lt).astype(np.int64)
            trg_next = np.concatenate([trg[1:], [1]]).astype(np.int64)  # 1 = <eos>
            self.pairs.append((src, trg, trg_next))

    def __getitem__(self, idx):
        return self.pairs[idx]

    def __len__(self):
        return len(self.pairs)


class WMT14(_WMTBase):
    def __init__(self, data_file=None, mode="train", dict_size=30000, download=True):
        super().__init__(9, dict_size, dict_size, mode)


class WMT16(_WMTBase):
    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en", download=True):
        super().__init__(11, src_dict_size, trg_dict_size, mode)


__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens", "WMT14", "WMT16"]
