"""Sequence tokenization and encoding, copied from
``explainable_spatial_vqa_tpu/core/tokenizer.py``, with the reference's
semantics:

- :func:`tokenize` (question and program text): split on a delimiter after
  optionally spacing out kept punctuation and stripping removed punctuation;
  lowercase; optional <START>/<END>;
- :func:`word_tokenize` (vocabulary building): the regex
  ``\\w+(?:'\\w+)?|[^\\w\\s.?]``;
- :func:`encode` / :func:`decode` with the special tokens.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "SPECIAL_TOKENS",
    "NULL",
    "START",
    "END",
    "UNK",
    "tokenize",
    "word_tokenize",
    "encode",
    "decode",
]

NULL, START, END, UNK = "<NULL>", "<START>", "<END>", "<UNK>"

SPECIAL_TOKENS: Dict[str, int] = {NULL: 0, START: 1, END: 2, UNK: 3}

# Words (with optional internal apostrophe) or single punctuation chars other
# than '.' and '?'.  Used when building the question vocabulary.
_WORD_RE = re.compile(r"\w+(?:'\w+)?|[^\w\s.?]")


def word_tokenize(text: str) -> List[str]:
    """Regex word tokenizer used for vocabulary building (build_vocab.py:60-62)."""
    return _WORD_RE.findall(text)


def tokenize(
    text: str,
    delim: str = " ",
    add_start_token: bool = True,
    add_end_token: bool = True,
    punct_to_keep: Optional[Iterable[str]] = None,
    punct_to_remove: Optional[Iterable[str]] = None,
) -> List[str]:
    """Delimiter tokenizer used when encoding sequences to ids.

    Matches the reference exactly, including its single double-space collapse
    performed *before* punctuation expansion (utils_preprocess.py:36-37).
    """
    if "  " in text:
        text = text.replace("  ", " ")
    if punct_to_keep is not None:
        for p in punct_to_keep:
            text = text.replace(p, f"{delim}{p}")
    if punct_to_remove is not None:
        for p in punct_to_remove:
            text = text.replace(p, "")
    tokens = [t.lower() for t in text.split(delim)]
    if add_start_token:
        tokens.insert(0, START)
    if add_end_token:
        tokens.append(END)
    return tokens


def encode(
    tokens: Sequence[str], token_to_idx: Dict[str, int], allow_unk: bool = False
) -> List[int]:
    """Map tokens to ids; unknown tokens become <UNK> or raise."""
    out: List[int] = []
    for token in tokens:
        if token not in token_to_idx:
            if not allow_unk:
                raise KeyError(f'Token "{token}" not in vocab')
            token = UNK
        out.append(token_to_idx[token])
    return out


def decode(
    ids: Sequence[int],
    idx_to_token: Dict[int, str],
    delim: Optional[str] = None,
    stop_at_end: bool = True,
):
    """Map ids back to tokens, optionally stopping at the first <END>."""
    tokens: List[str] = []
    for idx in ids:
        tokens.append(idx_to_token[int(idx)])
        if stop_at_end and tokens[-1] == END:
            break
    if delim is None:
        return tokens
    return delim.join(tokens)
