"""CLIP's byte-pair-encoding tokenizer (a Python merge loop, and a native one built from
``native/bpe_tokenizer.cpp`` at first use)."""

from .bpe import SimpleTokenizer, bytes_to_unicode, load_native_bpe

__all__ = ["SimpleTokenizer", "bytes_to_unicode", "load_native_bpe"]
