"""The text datasets of the port (counterpart of paddle_tpu/text/datasets.py;
reference python/paddle/text/datasets/): ``Imdb``, ``Imikolov``,
``Movielens``, ``UCIHousing``, ``Conll05st``, ``WMT14`` and ``WMT16``.

Nothing is read or downloaded: each dataset makes the JAX package's
deterministic synthetic set (the reference's sample structure, a signal a
model can learn) from numpy's ``RandomState``, seeded for ``mode="train"``
and one higher otherwise, with the same draws in the same order, so both
packages give the same samples bit for bit. Samples are numpy arrays on the
host; the DataLoader collates and moves them.
"""
from __future__ import annotations

import numpy as np

from ..io import Dataset


class Imdb(Dataset):
    """Sentiment classification: (token_ids[seq], label). Reference
    text/datasets/imdb.py (word-dict + tokenized reviews)."""

    def __init__(self, data_path=None, mode="train", cutoff=150, size=512,
                 seq_len=64, vocab_size=5000, seed=0):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 64)
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        # learnable: positive reviews draw tokens from the upper vocab half
        self.docs = np.empty((n, seq_len), np.int64)
        half = vocab_size // 2
        for i, lab in enumerate(self.labels):
            lo = half if lab else 0
            self.docs[i] = rng.randint(lo, lo + half, seq_len)
        self._word_idx = {f"w{i}": i for i in range(vocab_size)}

    def word_idx(self):
        return self._word_idx

    def __getitem__(self, idx):
        return self.docs[idx], np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """N-gram LM dataset: window of n-1 context ids + next id. Reference
    text/datasets/imikolov.py (PTB-style)."""

    def __init__(self, data_path=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, size=2048, vocab_size=2000,
                 seed=0):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 128)
        self.window_size = window_size
        # learnable: next word = (sum of context) % vocab
        ctx = rng.randint(0, vocab_size, (n, window_size - 1)).astype(np.int64)
        nxt = (ctx.sum(1) % vocab_size).astype(np.int64)
        self.data = np.concatenate([ctx, nxt[:, None]], axis=1)

    def __getitem__(self, idx):
        row = self.data[idx]
        return tuple(row[i:i + 1] for i in range(self.window_size))

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """Rating prediction: (user_id, gender, age, job, movie_id, category,
    title, rating). Reference text/datasets/movielens.py."""

    def __init__(self, data_path=None, mode="train", test_ratio=0.1,
                 rand_seed=0, size=1024):
        rng = np.random.RandomState(rand_seed if mode == "train" else rand_seed + 1)
        n = size if mode == "train" else max(int(size * test_ratio), 64)
        self.users = rng.randint(0, 1000, n).astype(np.int64)
        self.genders = rng.randint(0, 2, n).astype(np.int64)
        self.ages = rng.randint(0, 7, n).astype(np.int64)
        self.jobs = rng.randint(0, 21, n).astype(np.int64)
        self.movies = rng.randint(0, 2000, n).astype(np.int64)
        self.categories = rng.randint(0, 18, (n, 3)).astype(np.int64)
        self.titles = rng.randint(0, 1000, (n, 4)).astype(np.int64)
        # learnable rating: function of user/movie parity
        self.ratings = (((self.users + self.movies) % 5) + 1).astype(np.float32)

    def __getitem__(self, idx):
        return (self.users[idx:idx + 1], self.genders[idx:idx + 1],
                self.ages[idx:idx + 1], self.jobs[idx:idx + 1],
                self.movies[idx:idx + 1], self.categories[idx],
                self.titles[idx], np.asarray([self.ratings[idx]], np.float32))

    def __len__(self):
        return len(self.users)


class UCIHousing(Dataset):
    """Regression: (13 features, price). Reference text/datasets/uci_housing.py
    (the classic book/fit_a_line dataset)."""

    FEATURE_DIM = 13

    def __init__(self, data_path=None, mode="train", size=404, seed=0):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else 102
        self.x = rng.randn(n, self.FEATURE_DIM).astype(np.float32)
        w = np.linspace(-1.0, 1.0, self.FEATURE_DIM).astype(np.float32)
        self.y = (self.x @ w + 22.5 + 0.5 * rng.randn(n)).astype(np.float32)

    def __getitem__(self, idx):
        return self.x[idx], np.asarray([self.y[idx]], np.float32)

    def __len__(self):
        return len(self.x)


class Conll05st(Dataset):
    """SRL sequence labeling: word/predicate/context ids + BIO label sequence.
    Reference text/datasets/conll05.py."""

    def __init__(self, data_path=None, mode="train", size=256, seq_len=32,
                 word_vocab=5000, label_vocab=67, seed=0):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 32)
        self.words = rng.randint(0, word_vocab, (n, seq_len)).astype(np.int64)
        self.predicates = rng.randint(0, 3000, (n, 1)).astype(np.int64)
        self.labels = (self.words % label_vocab).astype(np.int64)
        self._word_dict = {f"w{i}": i for i in range(word_vocab)}
        self._label_dict = {f"l{i}": i for i in range(label_vocab)}
        self._predicate_dict = {f"p{i}": i for i in range(3000)}

    def get_dict(self):
        return self._word_dict, self._predicate_dict, self._label_dict

    def __getitem__(self, idx):
        return self.words[idx], self.predicates[idx], self.labels[idx]

    def __len__(self):
        return len(self.words)


class _WMTBase(Dataset):
    """Synthetic parallel corpus with the reference's (src_ids, trg_ids,
    trg_ids_next) sample shape and <s>/<e>/<unk> special tokens."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, mode="train", src_dict_size=1000, trg_dict_size=1000,
                 lang="en", size=512, seed=0):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = size if mode == "train" else max(size // 4, 64)
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size
        self.samples = []
        for _ in range(n):
            slen = rng.randint(3, 12)
            tlen = rng.randint(3, 12)
            src = rng.randint(3, src_dict_size, slen).astype(np.int64)
            trg = rng.randint(3, trg_dict_size, tlen).astype(np.int64)
            trg_in = np.concatenate([[self.BOS], trg]).astype(np.int64)
            trg_next = np.concatenate([trg, [self.EOS]]).astype(np.int64)
            self.samples.append((src, trg_in, trg_next))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)

    def get_dict(self, lang="en", reverse=False):
        vocab = {i: f"w{i}" for i in range(self.src_dict_size)}
        vocab[0], vocab[1], vocab[2] = "<s>", "<e>", "<unk>"
        if reverse:
            return vocab
        return {v: k for k, v in vocab.items()}


class WMT14(_WMTBase):
    """Reference: python/paddle/text/datasets/wmt14.py."""


class WMT16(_WMTBase):
    """Reference: python/paddle/text/datasets/wmt16.py."""
