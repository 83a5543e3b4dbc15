"""CLIP byte-pair-encoding tokenizer (host-side, pure Python): the port's
own copy of ``aaclip_tpu/text/bpe.py``, reading its own copy of the public
``bpe_simple_vocab_16e6.txt.gz`` merge table (the file beside this one).

The standard CLIP ``SimpleTokenizer`` algorithm (reference
model/tokenizer.py:74-186): byte-to-unicode remapping, lowercasing and
whitespace normalisation, word splitting, greedy lowest-rank pair merging
with an end-of-word marker, and fixed-length [N, 77] int32 sequences
wrapped in SOT/EOT.

CLIP splits words with the ``regex`` package's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+``. The standard library's ``re`` knows no
``\\p{..}`` classes, so ``_split_words`` scans the same alternatives by
hand with ``unicodedata`` categories, and the tokens need no package
beyond the standard library and numpy.
``ftfy`` text fixing is applied when the library is present, as in the JAX
package (a no-op for the ASCII prompt set).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Union

import numpy as np

try:  # optional dependency; identity for ASCII input
    import ftfy

    def _fix_text(s: str) -> str:
        return ftfy.fix_text(s)
except ImportError:
    def _fix_text(s: str) -> str:
        return s

VOCAB_PATH = os.path.join(os.path.dirname(__file__),
                          "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _split_words(text: str) -> List[str]:
    """``regex.findall`` of CLIP's word pattern (case-insensitive), with
    the alternatives tried in the pattern's order at each position."""
    words = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        hit = next((w for w in _SPECIAL + _CONTRACTIONS
                    if text[i:i + len(w)].lower() == w), None)
        if hit is not None:
            j = i + len(hit)
        elif _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            j = i + 1
        elif not c.isspace():
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode mapping used by GPT-2-style BPE."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


class ClipTokenizer:
    def __init__(self, vocab_path: str = VOCAB_PATH):
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # header line, then exactly 49152-256-2 merge rules
        merges = [tuple(line.split())
                  for line in lines[1:49152 - 256 - 2 + 1]]
        self._ranks = {pair: i for i, pair in enumerate(merges)}

        base = list(self._byte_enc.values())
        vocab = base + [c + "</w>" for c in base]
        vocab += ["".join(pair) for pair in merges]
        vocab += list(_SPECIAL)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)
        # special tokens pass through BPE unsplit (the reference pre-seeds
        # its cache the same way, model/tokenizer.py:87)
        self._cache: dict = {tok: [tok] for tok in _SPECIAL}

    def _merge_word(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            best_rank, best_idx = None, -1
            for i in range(len(parts) - 1):
                rank = self._ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_idx = rank, i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # merge every (non-overlapping) occurrence of the chosen pair
            out: List[str] = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == first
                        and parts[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._cache[token] = parts
        return parts

    @staticmethod
    def _clean(text: str) -> str:
        text = _fix_text(text)
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text.strip())
        return text.strip().lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _split_words(self._clean(text)):
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self._byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts: Union[str, List[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize to a zero-padded [N, context_length] int32 array with
    SOT/EOT wrapping (reference model/tokenizer.py:150-186)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context "
                                   f"length {context_length}")
            ids = ids[:context_length]
            ids[-1] = tok.eot_token
        out[i, :len(ids)] = ids
    return out
