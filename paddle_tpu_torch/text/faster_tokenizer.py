"""FasterTokenizer: BERT / ERNIE tokenization in front of the model
(counterpart of paddle_tpu/text/faster_tokenizer.py; reference
paddle/fluid/operators/string/faster_tokenizer_op.h: BasicTokenizer, then
WordPiece, with [CLS] / [SEP], pairs, truncation and padding).

Tokenization is host work. Each text goes through ``core/native/
tokenizer.cc`` (a byte-for-byte copy of the JAX package's source, built
with g++ at first use by ``core.native.load_library`` and bound with
ctypes); there is no Python fallback: a missing g++ or a failed build
raises. ``basic_tokenize`` and ``wordpiece_tokenize`` are the same
algorithm in Python, the tests' oracle. The ids come out as int64 tensors
on the current place (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.native import load_library
from ..device import resolve_device

__all__ = ["FasterTokenizer", "basic_tokenize", "wordpiece_tokenize"]


class _NativeTok:
    def __init__(self, vocab_lines: str, do_lower: bool):
        self._lib = load_library("tokenizer")
        self._lib.tk_create.restype = ctypes.c_void_p
        self._lib.tk_create.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
        self._lib.tk_tokenize.restype = ctypes.c_long
        self._lib.tk_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_long), ctypes.c_long]
        self._lib.tk_destroy.argtypes = [ctypes.c_void_p]
        blob = vocab_lines.encode("utf-8")
        self._h = self._lib.tk_create(blob, len(blob), int(do_lower))

    def tokenize(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        buf_len = max(16, 2 * len(text) + 8)
        buf = (ctypes.c_long * buf_len)()
        n = self._lib.tk_tokenize(self._h, data, buf, buf_len)
        if n > buf_len:  # rare: again at the exact size
            buf_len = n
            buf = (ctypes.c_long * buf_len)()
            n = self._lib.tk_tokenize(self._h, data, buf, buf_len)
        return list(buf[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tk_destroy(self._h)


# ---------------- the same algorithm in Python: the tests' oracle ----------------

_LATIN1_FOLD = {}
for lo, hi, base in ((0xE0, 0xE5, "a"), (0xE7, 0xE7, "c"), (0xE8, 0xEB, "e"),
                     (0xEC, 0xEF, "i"), (0xF1, 0xF1, "n"), (0xF2, 0xF6, "o"),
                     (0xF9, 0xFC, "u"), (0xFD, 0xFD, "y"), (0xFF, 0xFF, "y")):
    for c in range(lo, hi + 1):
        _LATIN1_FOLD[c] = base


def _fold(ch: str, lower: bool) -> str:
    c = ord(ch)
    if not lower:
        return ch
    if 0xC0 <= c <= 0xDE and c != 0xD7:
        c += 0x20
    return _LATIN1_FOLD.get(c, chr(c).lower() if c < 0x80 else chr(c))


def _is_cjk(c: int) -> bool:
    return (0x4E00 <= c <= 0x9FFF or 0x3400 <= c <= 0x4DBF or 0xF900 <= c <= 0xFAFF
            or 0x20000 <= c <= 0x2A6DF or 0x2A700 <= c <= 0x2CEAF
            or 0x2F800 <= c <= 0x2FA1F)


def _is_punct(c: int) -> bool:
    return (33 <= c <= 47 or 58 <= c <= 64 or 91 <= c <= 96 or 123 <= c <= 126
            or 0x2010 <= c <= 0x2027 or 0x3001 <= c <= 0x303F
            or 0xFF01 <= c <= 0xFF0F or 0xFF1A <= c <= 0xFF20
            or 0xFF3B <= c <= 0xFF40 or 0xFF5B <= c <= 0xFF65)


def _is_ws(c: int) -> bool:
    # tokenizer.cc's is_ws exactly: str.isspace() covers more codepoints
    # (U+1680, U+205F, U+2029, ...) and would give other ids than the
    # library's on the same text
    return (c in (0x20, 0x09, 0x0A, 0x0D, 0xA0, 0x2028, 0x3000)
            or 0x2000 <= c <= 0x200A)


def basic_tokenize(text: str, lower: bool) -> List[str]:
    """The basic tokenizer: fold, drop control characters, split on
    whitespace, isolate CJK ideographs and punctuation."""
    words, cur = [], []
    for ch in text:
        ch = _fold(ch, lower)
        c = ord(ch)
        if c in (0, 0xFFFD) or (c < 0x20 and ch not in "\t\n\r") or c == 0x7F \
                or 0x80 <= c <= 0x9F:
            continue
        if _is_ws(c):
            if cur:
                words.append("".join(cur)); cur = []
        elif _is_cjk(c) or _is_punct(c):
            if cur:
                words.append("".join(cur)); cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


def wordpiece_tokenize(word: str, vocab: Dict[str, int], unk_id: int,
                       max_chars: int = 100) -> List[int]:
    """Greedy longest-match WordPiece ids of one word (``unk_id`` for a
    word with no split or longer than ``max_chars``)."""
    if len(word) > max_chars:
        return [unk_id]
    pieces, start = [], 0
    while start < len(word):
        end, pid = len(word), -1
        while end > start:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                pid = vocab[sub]
                break
            end -= 1
        if pid < 0:
            return [unk_id]
        pieces.append(pid)
        start = end
    return pieces


class FasterTokenizer:
    """Batch text -> (input_ids, token_type_ids) int64 Tensors.

    vocab: dict token->id, path to a vocab.txt (one token per line), or a list
    of tokens. Mirrors the reference op attributes: do_lower_case,
    max_seq_len (0 = no truncation), pad_to_max_seq_len, is_split_into_words
    is not supported (the reference's tokenizer op also rejects it).
    """

    def __init__(self, vocab, do_lower_case: bool = True,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", unk_token: str = "[UNK]"):
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                tokens = [l.rstrip("\n") for l in f]
            self.vocab = {t: i for i, t in enumerate(tokens) if t}
            blob = "\n".join(tokens)
        elif isinstance(vocab, dict):
            # caller-assigned ids are preserved verbatim (a pruned vocab with
            # gaps must still index the right embedding rows)
            self.vocab = dict(vocab)
            blob = "\n".join(f"{t}\t{i}" for t, i in vocab.items())
        else:
            tokens = list(vocab)
            self.vocab = {t: i for i, t in enumerate(tokens) if t}
            blob = "\n".join(tokens)
        self.do_lower_case = do_lower_case
        self._native = _NativeTok(blob, do_lower_case)
        get = self.vocab.get
        self.unk_id = get(unk_token, 0)
        self.cls_id = get(cls_token, self.unk_id)
        self.sep_id = get(sep_token, self.unk_id)
        self.pad_id = get(pad_token, 0)

    # -- single text -> wordpiece ids (no special tokens) --
    def _encode(self, text: str) -> List[int]:
        return self._native.tokenize(text)

    def __call__(self, text: Union[str, Sequence[str]],
                 text_pair: Optional[Union[str, Sequence[str]]] = None,
                 max_seq_len: int = 0, pad_to_max_seq_len: bool = False, device=None):
        """(input_ids, token_type_ids), int64 [batch, width] on ``device``
        (the current place when None)."""
        texts = [text] if isinstance(text, str) else list(text)
        pairs = None
        if text_pair is not None:
            pairs = [text_pair] if isinstance(text_pair, str) else list(text_pair)
            if len(pairs) != len(texts):
                raise ValueError("text_pair batch size mismatch")

        if max_seq_len:
            min_len = 3 if pairs is not None else 2  # specials alone need this
            if max_seq_len < min_len:
                raise ValueError(
                    f"max_seq_len={max_seq_len} cannot hold the special tokens "
                    f"({min_len} needed for {'pair' if pairs else 'single'} input)")

        rows: List[Tuple[List[int], List[int]]] = []
        for i, t in enumerate(texts):
            a = self._encode(t)
            b = self._encode(pairs[i]) if pairs else None
            if max_seq_len:
                # reference: longest_first truncation keeping specials
                budget = max_seq_len - 2 - (1 if b is not None else 0)
                if b is None:
                    a = a[:budget]
                else:
                    while len(a) + len(b) > budget:
                        (a if len(a) >= len(b) else b).pop()
            ids = [self.cls_id] + a + [self.sep_id]
            tt = [0] * len(ids)
            if b is not None:
                ids += b + [self.sep_id]
                tt += [1] * (len(b) + 1)
            rows.append((ids, tt))

        width = max(len(r[0]) for r in rows)
        if pad_to_max_seq_len and max_seq_len:
            width = max_seq_len
        input_ids = np.full((len(rows), width), self.pad_id, np.int64)
        token_type = np.zeros((len(rows), width), np.int64)
        for r, (ids, tt) in enumerate(rows):
            input_ids[r, :len(ids)] = ids
            token_type[r, :len(tt)] = tt

        dev = resolve_device(device)
        return torch.from_numpy(input_ids).to(dev), torch.from_numpy(token_type).to(dev)
