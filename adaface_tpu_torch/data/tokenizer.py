"""CLIP text tokenization with extendable placeholder vocabulary.

The port's own copy of `adaface_tpu/data/tokenizer.py` (numpy only), so that
the torch package never imports the JAX one; both give identical ids.

The reference uses HF `CLIPTokenizer` (`ldm/modules/encoders/modules.py:185`)
and extends its vocab with placeholder tokens (`ldm/util.py:1371-1506`).
This is a self-contained re-implementation of the CLIP BPE scheme
(lowercase, whitespace collapse, byte-level unicode mapping, merges with
`</w>` end-of-word, BOS/EOS + max-length pad-with-EOS) that loads the
standard `vocab.json` + `merges.txt` assets from disk — this environment
has no network, so tokenizer data is asset-driven exactly like the SD
weights.

`HashTokenizer` is a deterministic stand-in with the same API for tests and
random-weight benchmarking where real BPE ids are irrelevant.
"""

from __future__ import annotations

import functools
import html
import json
import re
from typing import Dict, List, Sequence

import numpy as np

CLIP_VOCAB_SIZE = 49408
CLIP_MAX_LEN = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte->unicode table (reversible, no control chars)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# CLIP's word-split pattern uses unicode \p{L}/\p{N} classes (HF
# `tokenization_clip.py`). The `regex` module (a transformers dependency,
# present in this env) supports them; fall back to the ASCII equivalent if
# it is ever missing (non-ASCII then lands in the catch-all class, which
# only diverges on accented words — BPE ids still valid, just split
# differently).
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class TokenizerBase:
    """Shared API: encode to fixed-length [T] ids with BOS/EOS, placeholder
    registration appending ids after the base vocab."""

    vocab_size: int = CLIP_VOCAB_SIZE
    max_length: int = CLIP_MAX_LEN
    bos_id: int = CLIP_VOCAB_SIZE - 2  # 49406 <|startoftext|>
    eos_id: int = CLIP_VOCAB_SIZE - 1  # 49407 <|endoftext|>

    def __init__(self):
        self.extra_tokens: Dict[str, int] = {}

    def add_placeholder(self, string: str) -> int:
        if string in self.extra_tokens:
            return self.extra_tokens[string]
        tid = self.vocab_size + len(self.extra_tokens)
        self.extra_tokens[string] = tid
        return tid

    @property
    def num_extra_tokens(self) -> int:
        return len(self.extra_tokens)

    def _word_ids(self, word: str) -> List[int]:
        raise NotImplementedError

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _PAT.findall(_basic_clean(text)):
            if word in self.extra_tokens:
                ids.append(self.extra_tokens[word])
            else:
                ids.extend(self._word_ids(word))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int | None = None) -> np.ndarray:
        """[B, T] int32: BOS + ids (truncated) + EOS, padded with EOS like HF
        CLIPTokenizer(padding='max_length')."""
        T = max_length or self.max_length
        out = np.full((len(texts), T), self.eos_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[: T - 2]
            out[i, 0] = self.bos_id
            out[i, 1:1 + len(ids)] = ids
            # position 1+len(ids) already EOS via fill
        return out


class CLIPBPETokenizer(TokenizerBase):
    """Real CLIP BPE, loading `vocab.json` + `merges.txt` assets."""

    def __init__(self, vocab_path: str, merges_path: str):
        super().__init__()
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # merges.txt may carry a version header line
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self.byte_encoder = bytes_to_unicode()
        self.vocab_size = len(self.encoder)
        self.bos_id = self.encoder.get("<|startoftext|>", self.vocab_size - 2)
        self.eos_id = self.encoder.get("<|endoftext|>", self.vocab_size - 1)
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def _word_ids(self, word: str) -> List[int]:
        btext = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
        return [self.encoder[t] for t in self._bpe(btext) if t in self.encoder]


class HashTokenizer(TokenizerBase):
    """Deterministic hashed word ids in the CLIP id range — same API,
    for tests/benches with random weights (real BPE ids irrelevant)."""

    def _word_ids(self, word: str) -> List[int]:
        import hashlib

        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        return [h % (self.vocab_size - 3) + 1]  # avoid 0/BOS/EOS
