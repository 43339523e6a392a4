"""CLIP byte-pair-encoding tokenizer (standard library only).

Counterpart of neurons_tpu/data/clip_tokenizer.py: the same BPE over
CLIP's `bpe_simple_vocab_16e6.txt.gz` merges file, found through
`CLIP_BPE_PATH` or `bpe_path=`, and the same byte-level stand-in for
synthetic runs. Without the merges file tokenizing raises, unless the
caller allows the stand-in (`allow_fallback=True` or
NEURONS_TPU_ALLOW_BYTE_TOKENIZER=1, which the CLI's --tiny/--synthetic
modes set): its ids are not in CLIP's vocabulary.

Special tokens: <start_of_text>=49406, <end_of_text>=49407.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional, Sequence

SOT = 49406
EOT = 49407
CONTEXT_LENGTH = 77

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        if bpe_path is None or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; set CLIP_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz (ships with open_clip/CLIP).")
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        decoder = {v: k for k, v in self.encoder.items()}
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(decoder.get(int(t), "") for t in tokens)
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_tokenizer: Optional[SimpleTokenizer] = None


class _ByteFallbackTokenizer:
    """Byte-level stand-in used ONLY when the CLIP BPE merges file is
    absent (smoke/synthetic runs): ids are raw UTF-8 bytes. NOT
    CLIP-vocabulary-compatible — real runs must provide the merges file
    (set CLIP_BPE_PATH; it ships with the reference weight bundle)."""

    def encode(self, text: str) -> List[int]:
        return list(whitespace_clean(basic_clean(text)).lower()
                    .encode("utf-8"))

    def decode(self, tokens: Sequence[int]) -> str:
        return bytes(int(t) for t in tokens
                     if 0 <= int(t) < 256).decode("utf-8", errors="replace")


def tokenize(texts: Sequence[str], context_length: int = CONTEXT_LENGTH,
             bpe_path: Optional[str] = None,
             allow_fallback: Optional[bool] = None) -> List[List[int]]:
    """open_clip.tokenize-compatible: [SOT] + bpe + [EOT], truncated to
    `context_length` (EOT forced at the end when truncating). Returns Python
    lists (callers pad to their own fixed length).

    Without the merges file this raises unless the caller is a synthetic
    path (`allow_fallback=True`, or NEURONS_TPU_ALLOW_BYTE_TOKENIZER=1,
    which --tiny/--synthetic set): the byte-level stand-in's ids are not in
    CLIP's vocabulary, so stage 5's caption embeddings would be wrong while
    looking healthy. Point CLIP_BPE_PATH at CLIP's
    bpe_simple_vocab_16e6.txt.gz (it ships with open_clip/CLIP)."""
    global _tokenizer
    if allow_fallback is None:
        allow_fallback = os.environ.get(
            "NEURONS_TPU_ALLOW_BYTE_TOKENIZER") == "1"
    if _tokenizer is None:
        try:
            _tokenizer = SimpleTokenizer(bpe_path)
        except FileNotFoundError:
            if not allow_fallback:
                raise FileNotFoundError(
                    "CLIP BPE merges file not found. Set CLIP_BPE_PATH to "
                    "bpe_simple_vocab_16e6.txt.gz (ships with open_clip/"
                    "CLIP and with the reference weight bundle). The "
                    "byte-level fallback is only permitted on synthetic "
                    "paths (--tiny/--synthetic, or "
                    "NEURONS_TPU_ALLOW_BYTE_TOKENIZER=1), because its ids "
                    "are not CLIP-compatible.")
            import warnings
            warnings.warn("CLIP BPE merges file missing - using the "
                          "byte-level fallback tokenizer (ids are NOT "
                          "CLIP-compatible; set CLIP_BPE_PATH for real "
                          "runs)")
            _tokenizer = _ByteFallbackTokenizer()
    out = []
    for text in texts:
        ids = [SOT] + _tokenizer.encode(text) + [EOT]
        if len(ids) > context_length:
            ids = ids[:context_length]
            ids[-1] = EOT
        out.append(ids)
    return out
