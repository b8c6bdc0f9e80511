"""Numpy copy of ``tdnnf_nas_tpu.graphs.topology`` (chain topology, trees).

The chain topology is Kaldi's 1-state-per-phone HMM with two pdf-classes:
the *forward* pdf emitted on entry to the phone and the *self-loop* pdf
emitted on each additional frame.  Trees map (context, phone, pdf-class)
-> pdf id.  The +-1 ``CrossTriphoneTree`` is not ported yet (its committed
denominator composition waits with it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

FORWARD = 0  # pdf-class emitted on entering a phone
SELF_LOOP = 1  # pdf-class emitted on the phone's self-loop


@dataclasses.dataclass(frozen=True)
class ChainTopology:
    """Chain topology constants (Kaldi's untrained 0.5/0.5 self-loop)."""

    num_phones: int
    self_loop_prob: float = 0.5


class ContextIndependentTree:
    """CI tree: pdf = 2*phone + pdf_class.  num_pdfs = 2*num_phones."""

    def __init__(self, num_phones: int):
        self.num_phones = num_phones
        self.num_pdfs = 2 * num_phones
        self.context_width = 1

    def pdf(self, phone: int, pdf_class: int, left_phone: int = -1) -> int:
        return 2 * phone + pdf_class

    def forward_pdf(self, phone: int, left_phone: int = -1) -> int:
        return self.pdf(phone, FORWARD)

    def forward_pdf_ctx(self, phone: int, left=()) -> int:
        """``left`` is the left-phone tuple, most-recent first."""
        return self.forward_pdf(phone)

    def self_loop_pdf(self, phone: int) -> int:
        return self.pdf(phone, SELF_LOOP)


class BiphoneTree:
    """Left-biphone tree: forward pdfs depend on (left_phone, phone),
    self-loop pdfs on phone only.  ``num_leaves`` below num_phones^2 merges
    biphones by a seeded deterministic hash."""

    def __init__(self, num_phones: int, num_leaves: int | None = None):
        self.num_phones = num_phones
        self.context_width = 2
        n_biphones = num_phones * (num_phones + 1)  # left context incl. BOS
        if num_leaves is None or num_leaves >= n_biphones:
            self._fwd_table = np.arange(n_biphones, dtype=np.int64)
            n_fwd = n_biphones
        else:
            rng = np.random.RandomState(0)
            self._fwd_table = rng.randint(0, num_leaves,
                                          size=n_biphones).astype(np.int64)
            self._fwd_table[: num_phones] = (np.arange(num_phones)
                                             % num_leaves)
            n_fwd = num_leaves
        self._n_fwd = n_fwd
        self.num_pdfs = n_fwd + num_phones  # + per-phone self-loop pdfs

    def forward_pdf(self, phone: int, left_phone: int = -1) -> int:
        idx = phone * (self.num_phones + 1) + (left_phone + 1)
        return int(self._fwd_table[idx])

    def forward_pdf_ctx(self, phone: int, left=()) -> int:
        return self.forward_pdf(phone, left[0] if len(left) else -1)

    def self_loop_pdf(self, phone: int) -> int:
        return self._n_fwd + phone


class TriphoneTree:
    """Two-left-phone context tree (window [l2, l1, p]).

    ``forward_pdf_ctx(p, (l1, l2))`` looks up a flat [P, P+1, P+1] table
    (BOS = -1 in either slot); self-loop pdfs stay per-phone.  Built by
    likelihood clustering in ``graphs/tree_cluster.py``.
    """

    def __init__(self, num_phones: int, fwd_table, n_fwd: int):
        self.num_phones = num_phones
        self.context_width = 3
        self._fwd_table = np.asarray(fwd_table, np.int64).reshape(
            num_phones, num_phones + 1, num_phones + 1)
        self._n_fwd = int(n_fwd)
        self.num_pdfs = self._n_fwd + num_phones

    def forward_pdf(self, phone: int, left_phone: int = -1,
                    left2_phone: int = -1) -> int:
        return int(self._fwd_table[phone, left_phone + 1, left2_phone + 1])

    def forward_pdf_ctx(self, phone: int, left=()) -> int:
        l1 = left[0] if len(left) >= 1 else -1
        l2 = left[1] if len(left) >= 2 else -1
        return self.forward_pdf(phone, l1, l2)

    def self_loop_pdf(self, phone: int) -> int:
        return self._n_fwd + phone
