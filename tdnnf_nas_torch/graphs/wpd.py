"""Word-position-dependent phone marks (_B/_E/_I/_S) (port of
``tdnnf_nas_tpu.graphs.wpd``, pure Python, copied as it is).

Kaldi's `utils/prepare_lang.sh` (invoked from the reference's
`run.sh:139-257` data prep) marks every lexicon phone with its position in
the word — begin/end/internal/singleton — quadrupling the phone inventory
so the tree can split on word position (load-bearing for the reference's
lexicon/tree: every `tri*` system trains on marked phones).

Here the marks are a pure transform over the phone inventory: phone p at
position k becomes ``p * 4 + k``.  Everything downstream — tree stats,
den composition, numerator supervision, HCLG — already parameterizes over
``num_phones``, so marked systems need no special-casing; words are
unchanged, so WERs are directly comparable.

The JAX package's `scripts/wpd_compare.py` measures what the marks buy
on a corpus with word-boundary allophony, against a +-1 context tree
without marks (does left+right context subsume word position?).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

POS_B, POS_I, POS_E, POS_S = 0, 1, 2, 3
NUM_POS = 4


def num_marked_phones(num_phones: int) -> int:
    return num_phones * NUM_POS


def mark(phone: int, pos: int) -> int:
    return phone * NUM_POS + pos


def unmark(marked: int) -> Tuple[int, int]:
    """(base phone, position)."""
    return marked // NUM_POS, marked % NUM_POS


def mark_pron(pron: Sequence[int]) -> Tuple[int, ...]:
    """One word's pronunciation -> position-marked phone ids."""
    n = len(pron)
    if n == 1:
        return (mark(pron[0], POS_S),)
    out = [mark(pron[0], POS_B)]
    out.extend(mark(p, POS_I) for p in pron[1:-1])
    out.append(mark(pron[-1], POS_E))
    return tuple(out)


def mark_lexicon(prons: Dict[int, Sequence[int]]) -> Dict[int, Tuple[int, ...]]:
    return {w: mark_pron(p) for w, p in prons.items()}


def mark_word_stream(words: Sequence[int],
                     prons: Dict[int, Sequence[int]]) -> List[int]:
    """Flat marked phone stream of a word sequence (no optional silence)."""
    out: List[int] = []
    for w in words:
        out.extend(mark_pron(prons[w]))
    return out


def positions_of_stream(words: Sequence[int],
                        prons: Dict[int, Sequence[int]]) -> List[int]:
    """Per-phone position class of the flat phone stream (for corpus
    generators that color emissions by word position)."""
    out: List[int] = []
    for w in words:
        n = len(prons[w])
        if n == 1:
            out.append(POS_S)
        else:
            out.append(POS_B)
            out.extend([POS_I] * (n - 2))
            out.append(POS_E)
    return out
