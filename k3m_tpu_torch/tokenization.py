"""BERT-style WordPiece tokenizer for K3M (the port's own copy of
k3m_tpu/tokenization.py: same behaviour and vocabulary layout, with the
per-character and per-token work memoized).

The reference uses HuggingFace `BertTokenizer.from_pretrained("bert-base-chinese"
/ "hfl/chinese-roberta-wwm-ext")` (reference train_concap_struc.py:222,
pretrain.py — both share the 21128-entry Chinese vocab). Two hard behavioural
contracts from the reference that we must preserve:

  * `encode(text)` returns token ids WITHOUT special tokens, and
    `add_special_tokens_single_sentence(ids)` wraps them as
    [CLS] + ids + [SEP]   (concept_cap_dataset_struc.py:605-675).
  * Token id 131 must be ':' and id 132 must be ';' — the pv masking and
    span-indexing logic is keyed on those two raw ids
    (concept_cap_dataset_struc.py:785-840).

This environment has no network and no cached vocab file, so we ship a
deterministic synthetic vocabulary with the same layout as bert-base-chinese
for the id range that matters ([PAD]=0, [unused*]=1..99, [UNK]=100, [CLS]=101,
[SEP]=102, [MASK]=103, <S>=104, <T>=105, printable ASCII '!'..'~' at
106..199 — which pins ':'=131, ';'=132 — then CJK ideographs). A real
bert-base-chinese `vocab.txt` can be dropped in via `WordPieceTokenizer(vocab_file=...)`
for exact id-level parity with the reference.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"

DEFAULT_VOCAB_SIZE = 21128


def build_synthetic_vocab(vocab_size: int = DEFAULT_VOCAB_SIZE) -> List[str]:
    """Deterministic vocab with bert-base-chinese's special-token layout."""
    vocab: List[str] = [PAD_TOKEN]
    vocab += [f"[unused{i}]" for i in range(1, 100)]          # ids 1..99
    vocab += [UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN, "<S>", "<T>"]  # 100..105
    vocab += [chr(c) for c in range(0x21, 0x7F)]               # 106..199 ('!'..'~')
    assert vocab.index(":") == 131 and vocab.index(";") == 132
    # CJK Unified Ideographs, then extension A, in codepoint order.
    cp = 0x4E00
    while len(vocab) < vocab_size and cp <= 0x9FFF:
        vocab.append(chr(cp))
        cp += 1
    cp = 0x3400
    while len(vocab) < vocab_size and cp <= 0x4DBF:
        vocab.append(chr(cp))
        cp += 1
    return vocab[:vocab_size]


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class _CleanTable(dict):
    """`str.translate` table of the basic tokenizer's character cleaning,
    filled on first sight of each character."""

    def __missing__(self, cp: int) -> str:
        ch = chr(cp)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            out = ""
        elif _is_whitespace(ch):
            out = " "
        elif _is_cjk(cp):
            out = f" {ch} "
        else:
            out = ch
        self[cp] = out
        return out


_MAX_CACHED_TOKENS = 1 << 20


def _validate_vocab_layout(vocab_list: List[str], path: str) -> None:
    """Fail loudly if a user-supplied vocab.txt breaks the reference's hard
    id contracts (first-real-asset-run guard, VERDICT r2 §4):

      * pv masking/span indexing is keyed on raw ids 131=':' and 132=';'
        (reference concept_cap_dataset_struc.py:785-840) — a vocab with a
        different layout silently corrupts every pv span;
      * special-token layout of bert-base-chinese/roberta-wwm-ext:
        [PAD]=0 [UNK]=100 [CLS]=101 [SEP]=102 [MASK]=103.

    Set K3M_SKIP_VOCAB_CHECK=1 only for deliberately non-BERT-Chinese
    vocabularies (then pv masking semantics are the caller's problem)."""
    if os.environ.get("K3M_SKIP_VOCAB_CHECK"):
        return
    expected = {0: PAD_TOKEN, 100: UNK_TOKEN, 101: CLS_TOKEN, 102: SEP_TOKEN,
                103: MASK_TOKEN, 131: ":", 132: ";"}
    problems = []
    for idx, tok in expected.items():
        got = vocab_list[idx] if idx < len(vocab_list) else "<missing>"
        if got != tok:
            problems.append(f"id {idx}: expected {tok!r}, got {got!r}")
    if problems:
        raise ValueError(
            f"{path} does not have the bert-base-chinese id layout the "
            f"reference's pv masking depends on: {'; '.join(problems)} "
            f"(set K3M_SKIP_VOCAB_CHECK=1 to override)")


class WordPieceTokenizer:
    """BasicTokenizer + WordPiece, matching HF BertTokenizer behaviour.

    Lowercases, strips accents, splits CJK chars individually, splits
    punctuation, then greedy-longest-match WordPiece with '##' continuations.
    """

    def __init__(self, vocab_file: Optional[str] = None,
                 vocab_size: int = DEFAULT_VOCAB_SIZE,
                 do_lower_case: bool = True,
                 max_chars_per_word: int = 100,
                 char_fallback: Optional[bool] = None):
        if vocab_file is not None:
            if not os.path.exists(vocab_file):
                # never silently fall back to the synthetic vocab when the
                # user asked for a real one — a typo'd path would otherwise
                # train on wrong token ids without a peep
                raise FileNotFoundError(
                    f"--vocab_file {vocab_file} does not exist")
            with open(vocab_file, encoding="utf-8") as f:
                self.vocab_list = [line.rstrip("\n") for line in f]
            _validate_vocab_layout(self.vocab_list, vocab_file)
            # Real vocab: HF-exact WordPiece (whole token -> [UNK] when
            # greedy matching fails), byte-identical to BertTokenizer.
            self.char_fallback = bool(char_fallback) if char_fallback is not None else False
        else:
            self.vocab_list = build_synthetic_vocab(vocab_size)
            # Synthetic vocab ships no '##' pieces; per-char fallback keeps
            # ASCII words representable instead of collapsing to [UNK].
            self.char_fallback = True if char_fallback is None else bool(char_fallback)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self.vocab_list)}
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self.pad_token_id = self.vocab[PAD_TOKEN]
        self.unk_token_id = self.vocab[UNK_TOKEN]
        self.cls_token_id = self.vocab[CLS_TOKEN]
        self.sep_token_id = self.vocab[SEP_TOKEN]
        self.mask_token_id = self.vocab[MASK_TOKEN]
        self.mask_token = MASK_TOKEN
        self._clean = _CleanTable()
        self._pieces: Dict[str, List[str]] = {}

    def __len__(self) -> int:
        return len(self.vocab_list)

    # -------------------------------------------------------------- basic

    def _split_token(self, tok: str) -> List[str]:
        """Lowercase, strip accents and split punctuation off one
        whitespace-delimited token."""
        if self.do_lower_case:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        tokens: List[str] = []
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
        return tokens

    # ---------------------------------------------------------- wordpiece

    def _wordpiece(self, token: str) -> List[str]:
        """Greedy longest-match-first WordPiece.

        With `char_fallback=False` (any real vocab file) this is the exact
        HF `WordpieceTokenizer.tokenize` algorithm: a token where matching
        fails at any position becomes a single [UNK]
        (verified byte-identical to transformers.BertTokenizer in
        tests/test_tokenizer_hf_parity.py). With `char_fallback=True`
        (synthetic vocab, which has no '##' pieces) unmatched positions
        degrade to raw chars instead.
        """
        if len(token) > self.max_chars_per_word:
            return [UNK_TOKEN]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                if not self.char_fallback:
                    return [UNK_TOKEN]  # HF: whole token is bad
                ch = token[start]
                pieces.append(ch if ch in self.vocab else UNK_TOKEN)
                start += 1
            else:
                pieces.append(piece)
                start = end
        return pieces

    # ------------------------------------------------------------- public

    def tokenize(self, text: str) -> List[str]:
        """Clean the text (drop NUL, U+FFFD and control characters, map
        whitespace to ' ', pad CJK characters with spaces so each is its
        own token), split on whitespace, then split and WordPiece each
        token. Both steps are memoized: per character in `_clean` and per
        token in `_pieces`, because product text repeats the same few
        thousand characters."""
        out: List[str] = []
        pieces = self._pieces
        for tok in text.translate(self._clean).split():
            p = pieces.get(tok)
            if p is None:
                if len(pieces) >= _MAX_CACHED_TOKENS:
                    pieces.clear()
                p = pieces[tok] = [w for t in self._split_token(tok)
                                   for w in self._wordpiece(t)]
            out.extend(p)
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.vocab_list[i] if 0 <= i < len(self.vocab_list) else UNK_TOKEN
                for i in ids]

    def encode(self, text: str) -> List[int]:
        """Token ids, NO special tokens (matches pytorch_transformers encode)."""
        return self.convert_tokens_to_ids(self.tokenize(text))

    def add_special_tokens_single_sentence(self, ids: List[int]) -> List[int]:
        return [self.cls_token_id] + list(ids) + [self.sep_token_id]

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.vocab_list) + "\n")


def get_tokenizer(vocab_file: Optional[str] = None,
                  vocab_size: int = DEFAULT_VOCAB_SIZE) -> WordPieceTokenizer:
    return WordPieceTokenizer(vocab_file=vocab_file, vocab_size=vocab_size)
