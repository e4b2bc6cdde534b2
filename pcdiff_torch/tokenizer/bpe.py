"""CLIP-compatible byte-pair-encoding tokenizer.

Counterpart of :mod:`pcdiff.tokenizer.bpe`, the same scheme: GPT-2's bytes-to-unicode
mapping, CLIP's word pattern, lower case and whitespace normalisation, BPE merges with
``</w>`` end-of-word markers, and ``<|startoftext|>`` / ``<|endoftext|>`` framing to a
fixed context length. The word pattern (``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|
'll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``, case-insensitive) is matched by a scanner
on :mod:`unicodedata` categories, so the port needs no ``regex`` package.

The merge loop runs in Python, or with ``use_native`` (the default) in the library of
``native/bpe_tokenizer.cpp``, which this module builds with the host's ``g++`` at first use
into ``build/pcdiff_torch/libbpe_tokenizer.so`` (rebuilt when older than its source; the
JAX package loads the ``native/libbpe_tokenizer.so`` built by its Makefile instead). Where
there is no host compiler the Python loop runs; a build that fails raises. Both give the
same tokens.

Vocabulary: the standard CLIP merges file (``bpe_simple_vocab_16e6.txt[.gz]``); the vocab
ordering matches OpenAI's, so ids line up with published CLIP checkpoints.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
import html
import os
import shutil
import subprocess
import threading
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SimpleTokenizer", "bytes_to_unicode", "load_native_bpe", "native_available"]

_ROOT = Path(__file__).resolve().parents[2]  # the checkout
SOURCE = _ROOT / "native" / "bpe_tokenizer.cpp"
BUILD_DIR = _ROOT / "build" / "pcdiff_torch"
LIBRARY = BUILD_DIR / "libbpe_tokenizer.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lock = threading.Lock()


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _findall_words(text: str) -> List[str]:
    """The matches of CLIP's word pattern in ``text``, left to right, each alternative tried
    in the pattern's order at each position (the specials and contractions case-insensitive);
    characters no alternative matches (whitespace) are skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        match = None
        for lit in _SPECIALS + _CONTRACTIONS:
            if text[i:i + len(lit)].lower() == lit:
                match = lit
                break
        if match is not None:
            j = i + len(match)
        elif _letter(ch):
            j = i + 1
            while j < n and _letter(text[j]):
                j += 1
        elif _number(ch):
            j = i + 1
        elif not ch.isspace():
            j = i + 1
            while j < n and not (text[j].isspace() or _letter(text[j]) or _number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def native_available() -> bool:
    """Whether this machine has the host compiler that builds the native merge loop."""
    return shutil.which("g++") is not None


def _library() -> Optional[Path]:
    """The native library, built first where it is missing or older than its source; None
    where there is no host compiler. A build that fails raises."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    with _lock:
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}")
            os.replace(tmp, LIBRARY)
    return LIBRARY


class _NativeBPE:
    """ctypes wrapper over the native merge loop."""

    def __init__(self, lib_path: Path, merges: Sequence[Tuple[str, str]]):
        self.lib = ctypes.CDLL(str(lib_path))
        self.lib.bpe_create.restype = ctypes.c_void_p
        self.lib.bpe_create.argtypes = [ctypes.c_char_p]
        self.lib.bpe_apply.restype = ctypes.c_int
        self.lib.bpe_apply.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int]
        self.lib.bpe_free.argtypes = [ctypes.c_void_p]
        text = "\n".join(f"{a} {b}" for a, b in merges)
        self.handle = self.lib.bpe_create(text.encode("utf-8"))
        self._buf = ctypes.create_string_buffer(1 << 16)

    def __call__(self, token: str) -> str:
        n = self.lib.bpe_apply(self.handle, token.encode("utf-8"), self._buf, len(self._buf))
        if n < 0:
            raise ValueError("bpe output buffer overflow")
        return self._buf.raw[:n].decode("utf-8")

    def __del__(self):
        handle, self.handle = getattr(self, "handle", None), None
        if handle:
            self.lib.bpe_free(handle)


def load_native_bpe(merges: Sequence[Tuple[str, str]]) -> Optional[_NativeBPE]:
    """The native merge loop over ``merges`` (built at first use), or None where there is no
    host compiler."""
    lib = _library()
    return None if lib is None else _NativeBPE(lib, merges)


class SimpleTokenizer:
    """CLIP BPE tokenizer (the native merge loop with ``use_native`` where it builds)."""

    def __init__(self, bpe_path: str, use_native: bool = True):
        byte_encoder = bytes_to_unicode()
        self.byte_encoder = byte_encoder
        opener = gzip.open if str(bpe_path).endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the standard merges file: a header line, then the ranked merges (rows 1..48894)
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1] if m]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        vocab = list(byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += list(_SPECIALS)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._native = load_native_bpe(merges) if use_native else None
        self._cache: Dict[str, str] = {s: s for s in _SPECIALS}

    def _bpe_python(self, token: str) -> str:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        return " ".join(word)

    def bpe(self, token: str) -> str:
        if token not in self._cache:
            self._cache[token] = (self._native(token) if self._native is not None
                                  else self._bpe_python(token))
        return self._cache[token]

    def _clean(self, text: str) -> str:
        text = html.unescape(html.unescape(text))
        return " ".join(text.strip().split()).lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _findall_words(self._clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        return bytearray(byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = 77, truncate: bool = True) -> np.ndarray:
        """Prompts -> int32 ``[N, context_length]`` ids, SOT and EOT framed, zero padded."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"input is too long for context length {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
