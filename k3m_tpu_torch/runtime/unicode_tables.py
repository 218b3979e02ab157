"""Unicode classification and transform tables for the native tokenizer.

The port's copy of k3m_tpu/runtime/unicode_tables.py. The C++ basic
tokenizer (preprocess.cc) must reproduce k3m_tpu_torch/tokenization.py
exactly, so rather than reimplementing Unicode in C++ this module walks
every codepoint with the port tokenizer's own predicates and Python's
`unicodedata`, and passes the results in as tables:

  * a flag byte per codepoint (whitespace, control, punctuation, CJK,
    dropped, and `str.isspace` for `str.split`), and
  * the transform strip_Mn(NFD(lower(chr(cp)))) of the lower/strip-accents
    step, as (offset, length) runs into a flat pool of codepoints, length
    0xFF meaning "unchanged".

(A known divergence, as in the JAX package: the table lowers U+03A3 GREEK
CAPITAL SIGMA without context, where `str.lower` applies the Final_Sigma
rule; product text in this domain is Chinese.)

Walking 0x110000 codepoints takes seconds, so the tables are cached as an
.npz under the checkout's ignored `build/k3m_tpu_torch/native/`, keyed by
the table version and `unicodedata.unidata_version`.
"""

from __future__ import annotations

import os
import unicodedata
from pathlib import Path

import numpy as np

from k3m_tpu_torch.tokenization import (
    _is_cjk, _is_control, _is_punctuation, _is_whitespace,
)

MAX_CP = 0x110000

F_WS = 1        # _is_whitespace
F_CTRL = 2      # _is_control
F_PUNCT = 4     # _is_punctuation
F_CJK = 8       # _is_cjk
F_DROP = 16     # cp == 0 or cp == 0xFFFD (dropped by the cleaning)
F_PYSPACE = 32  # str.isspace() (the separators of str.split())

_VERSION = 1
_IDENTITY = 0xFF  # trlen sentinel: transform(cp) == [cp]
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "k3m_tpu_torch" / "native"


def _build():
    flags = np.zeros(MAX_CP, np.uint8)
    troff = np.full(MAX_CP, -1, np.int32)
    trlen = np.full(MAX_CP, _IDENTITY, np.uint8)
    pool: list = []
    cat = unicodedata.category
    nfd = unicodedata.normalize
    for cp in range(MAX_CP):
        ch = chr(cp)
        flags[cp] = ((F_WS if _is_whitespace(ch) else 0)
                     | (F_CTRL if _is_control(ch) else 0)
                     | (F_PUNCT if _is_punctuation(ch) else 0)
                     | (F_CJK if _is_cjk(cp) else 0)
                     | (F_DROP if cp in (0, 0xFFFD) else 0)
                     | (F_PYSPACE if ch.isspace() else 0))
        out = [ord(x) for x in nfd("NFD", ch.lower()) if cat(x) != "Mn"]
        if out != [cp]:
            assert len(out) < _IDENTITY
            troff[cp] = len(pool)
            trlen[cp] = len(out)
            pool.extend(out)
    return flags, troff, trlen, np.asarray(pool, np.uint32)


def get_tables():
    """(flags[MAX_CP] u8, troff[MAX_CP] i32, trlen[MAX_CP] u8, pool u32)."""
    path = CACHE_DIR / f"unicode_tables-v{_VERSION}-{unicodedata.unidata_version}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["flags"], z["troff"], z["trlen"], z["trpool"]
    flags, troff, trlen, trpool = _build()
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    # np.savez appends ".npz" to a name without it: name the temporary
    # file with the suffix, so that the atomic rename finds it
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
    np.savez_compressed(tmp, flags=flags, troff=troff, trlen=trlen, trpool=trpool)
    os.replace(tmp, path)
    return flags, troff, trlen, trpool
