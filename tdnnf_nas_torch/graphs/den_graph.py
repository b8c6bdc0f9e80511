"""Numpy copy of ``tdnnf_nas_tpu.graphs.den_graph`` (denominator graphs).

Equivalent of Kaldi's ``chain-make-den-fst``, in two forms:

* dense (bigram LM x chain topology x CI or left-biphone tree):
  ``build_denominator_graph`` returns a ``graphs.fsa.StateGraph`` whose
  device copy is ``ops.fwdbwd.DenGraphArrays.from_graph``;
  ``den_init_lookup`` maps numerator states to its initial probs;
* composed (n-gram LM x topology x context tree):
  ``compile_denominator_fsa`` builds the factored state-emitting FSA (for
  a +-1 tree, the committed-successor composition) and
  ``CompiledDenFsa.to_blocked`` its superblocked export, whose device copy
  is ``ops.fwdbwd.BlockedDenGraph.from_host``; the committed graph's
  wildcard positions become its rank-R broadcast term.

When the blocked export refuses a den (its padded blocks over their
budget: the +-1 den at the bench's scale), ``CompiledDenFsa.to_factored``
exports the position-factored form, whose device copy is
``ops.fwdbwd.FactoredDenGraph.from_host``.
``CompiledDenFsa.to_state_graph`` is its dense [S,S] export (small
graphs: the phone decode of ``recipes.chain_recipes.decode_corpus``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from tdnnf_nas_torch.graphs.fsa import StateGraph, stationary_init
from tdnnf_nas_torch.graphs.phone_lm import BOS, NGramPhoneLM, PhoneLM
from tdnnf_nas_torch.graphs.topology import BiphoneTree, ChainTopology


def den_init_lookup(g: StateGraph, num_phones: int):
    """Map a numerator state (phone, kind, left) -> den-graph initial prob.

    kind 0 = enter, 1 = loop.  Layout must match build_denominator_graph:
    CI graphs index enter states by phone and loop states by P+phone;
    biphone graphs index enter states by (left+1)*P + phone.
    """
    s = g.num_states
    if s == 2 * num_phones:  # CI layout
        return lambda p, kind, left=-1: float(
            g.init[p] if kind == 0 else g.init[num_phones + p]
        )
    n_enter = (num_phones + 1) * num_phones
    if s != n_enter + num_phones:
        raise ValueError("unknown den-graph layout")
    return lambda p, kind, left=-1: float(
        g.init[(left + 1) * num_phones + p] if kind == 0 else g.init[n_enter + p]
    )


def build_denominator_graph(lm: PhoneLM, topo: ChainTopology, tree) -> StateGraph:
    """Dense den graph of a bigram LM: for each phone p an enter state
    (p's forward pdf) and a loop state (p's self-loop pdf); from either,
    -> loop(p) with self_loop_prob and -> enter(q) with
    (1 - self_loop_prob) * P_lm(q | p).  Initial probs are the averaged
    power-iteration occupancies from the BOS row; finals are 1.  A
    left-biphone tree splits the enter states per left context
    (``_build_biphone``)."""
    p_count = lm.num_phones
    if topo.num_phones != p_count:
        raise ValueError("phone count mismatch between LM and topology")
    a = topo.self_loop_prob
    if isinstance(tree, BiphoneTree):
        return _build_biphone(lm, topo, tree)
    # CI / shared-context tree: states [enter(0..P-1), loop(0..P-1)]
    s = 2 * p_count
    trans = np.zeros((s, s), dtype=np.float64)
    state_pdf = np.zeros((s,), dtype=np.int32)
    for p in range(p_count):
        state_pdf[p] = tree.forward_pdf(p)
        state_pdf[p_count + p] = tree.self_loop_pdf(p)
        for src in (p, p_count + p):
            trans[src, p_count + p] += a
            trans[src, :p_count] += (1.0 - a) * lm.probs[p + 1].astype(np.float64)
    g = StateGraph(
        trans=trans.astype(np.float32),
        state_pdf=state_pdf,
        init=np.full((s,), 1.0 / s, dtype=np.float32),
        final=np.ones((s,), dtype=np.float32),
        num_pdfs=tree.num_pdfs,
    ).normalize()
    start = np.zeros((s,), np.float64)
    start[:p_count] = lm.probs[0].astype(np.float64)  # BOS row -> enter states
    g = StateGraph(
        trans=g.trans,
        state_pdf=g.state_pdf,
        init=stationary_init(g.trans, start=start, average=True),
        final=g.final,
        num_pdfs=g.num_pdfs,
    )
    g.validate()
    return g


@dataclasses.dataclass
class BlockedDenGraph:
    """Host (numpy) superblocked denominator graph.

    Layout per superblock c: ``[R*NDPOS enter slots | NSRC loop slots]``
    (NDp = R*NDPOS + NSRC slots, V = C*NDp in all); see
    ``ops/fwdbwd.BlockedDenGraph`` for the per-frame recursion.
    ``bcast_sel``/``bcast_vec`` are the rank-R wildcard term of committed
    (+-1) graphs: ``bcast_sel`` [C*NSRC, R'] marks each group's source
    slots (a slot is in at most one group), ``bcast_vec`` [R', V] is the
    group's shared out-row.
    """

    w_blocks: np.ndarray  # [C, NSRC, NDp] f32
    perm: np.ndarray  # [C*NSRC] int32 into beta_dst padded (CND = zero slot)
    perm_inv: np.ndarray  # [C*NDPOS] int32 inverse (C*NSRC = no source)
    init_pos: np.ndarray  # [C*NSRC] f32 per-subposition init sums (leaky)
    pdf_virtual: np.ndarray  # [V] int32
    init_virtual: np.ndarray  # [V] f32
    final_virtual: np.ndarray  # [V] f32
    bcast_sel: Optional[np.ndarray]  # [C*NSRC, R'] f32 or None
    bcast_vec: Optional[np.ndarray]  # [R', V] f32 or None
    enter_pad: int = 4  # R
    num_states: int = 0
    num_pdfs: int = 0

    @property
    def shape(self):
        c, nsrc, ndp = self.w_blocks.shape
        return c, nsrc, ndp


@dataclasses.dataclass
class FactoredDenGraph:
    """Host (numpy) position-factored denominator graph.

    The fields of the reference's device ``FactoredDenGraph``
    (``seg_bounds``, ``state_pdf``, ``init``, ``final``, ``trans_pos``,
    ``pdf_perm``, ``pdf_bounds``), with the arc list sorted by destination
    state in place of its padded [S, K] in-arc tables ``in_pos``/``in_w``
    (the same arcs, row by row, without the padding to the largest
    in-degree K: 424.6 M entries a table on the bench-scale +-1 den).  The
    scan sums over the arc list when the dense ``trans_pos`` is not built.
    See ``ops/fwdbwd.FactoredDenGraph`` for the recursion.
    """

    seg_bounds: np.ndarray  # [Npos+1] int32
    state_pdf: np.ndarray  # [S] int32
    init: np.ndarray  # [S] f32
    final: np.ndarray  # [S] f32
    trans_pos: Optional[np.ndarray]  # [Npos, S] f32 or None
    pdf_perm: np.ndarray  # [S] int32 states sorted by pdf
    pdf_bounds: np.ndarray  # [P+1] int32 runs of equal pdfs in pdf_perm
    # arcs sorted by destination (stable): dst_bounds[s]..dst_bounds[s+1]
    # are the arcs into state s
    arc_dst: np.ndarray  # [A] int32
    arc_src_pos: np.ndarray  # [A] int32
    arc_w: np.ndarray  # [A] f32
    dst_bounds: np.ndarray  # [S+1] int64
    num_pdfs: int = 0

    @property
    def num_states(self) -> int:
        return int(self.state_pdf.shape[0])

    @property
    def num_positions(self) -> int:
        return int(self.seg_bounds.shape[0]) - 1

    @property
    def num_arcs(self) -> int:
        return int(self.arc_dst.shape[0])

    @property
    def max_in_degree(self) -> int:
        """K, the in-degree the reference's padded tables pad every state
        to."""
        return max(1, int(np.diff(self.dst_bounds).max(initial=0)))


@dataclasses.dataclass
class CompiledDenFsa:
    """Host-side composed denominator FSA (LM x topology x tree).

    States are split only by emitted pdf and grouped into *positions*
    with shared out-behaviour.
    """

    num_positions: int
    num_states: int
    num_pdfs: int
    seg_bounds: np.ndarray  # [Npos+1] int32
    state_pdf: np.ndarray  # [S] int32
    # factored arcs: dest state <- source POSITION with probability w
    arc_dst: np.ndarray  # [A] int32 (state id)
    arc_src_pos: np.ndarray  # [A] int32 (position id)
    arc_w: np.ndarray  # [A] float32
    init: np.ndarray  # [S] float32 (stationary)
    final: np.ndarray  # [S] float32
    # numerator-lookup tables (keys produced by walking the LM FSA)
    enter_state: Dict[Tuple[int, int], int]  # (pos_id, pdf) -> state id
    loop_state: Dict[int, int]  # pos_id -> state id
    start_pos: int  # position id at BOS
    pos_trans: Dict[Tuple[int, int], Tuple[int, int]]  # (pos, phone) -> (dest pos, pdf)
    # committed-successor composition (+-1 right-context trees): positions
    # carry the next phone; walk keys are (pos, commitment) from normal
    # positions and (pos, consumed, commitment) from wildcard ones
    committed: bool = False
    # positions whose out-arcs span source classes but are identical across
    # the group (the committed composition's wildcard/EOS restarts): the
    # blocked export factors them as rank-R broadcast terms
    wildcard_positions: Optional[List[int]] = None

    def to_state_graph(self) -> StateGraph:
        """Dense [S,S] export (tests / small graphs)."""
        s = self.num_states
        trans = np.zeros((s, s), np.float64)
        for dst, sp, w in zip(self.arc_dst, self.arc_src_pos, self.arc_w):
            lo, hi = self.seg_bounds[sp], self.seg_bounds[sp + 1]
            trans[lo:hi, dst] += w
        g = StateGraph(
            trans=trans.astype(np.float32),
            state_pdf=self.state_pdf,
            init=self.init,
            final=self.final,
            num_pdfs=self.num_pdfs,
        )
        g.validate(stochastic=False)
        return g

    def to_factored(self, dense_budget: int = 256_000_000
                    ) -> FactoredDenGraph:
        """Host FactoredDenGraph (position-factored form).

        When Npos * S fits ``dense_budget`` entries, also materialises the
        dense [Npos, S] position->state transition ``trans_pos`` (the scan
        then runs one float32 matmul a frame); beyond it the scan sums
        over the destination-sorted arc list.  The reference's hi/lo bf16
        split of ``trans_pos`` is a TPU workaround and is not kept.
        """
        s = self.num_states
        order = np.argsort(self.arc_dst, kind="stable")
        dst = np.asarray(self.arc_dst[order], np.int32)
        srcp = np.asarray(self.arc_src_pos[order], np.int32)
        w = np.asarray(self.arc_w[order], np.float32)
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(dst, minlength=s))]).astype(np.int64)
        trans_pos = None
        if self.num_positions * s <= dense_budget:
            trans_pos = np.zeros((self.num_positions, s), np.float32)
            np.add.at(trans_pos, (self.arc_src_pos, self.arc_dst),
                      self.arc_w)
        # states sorted by pdf, for the segment-sum obs-gather backward
        spdf = np.asarray(self.state_pdf)
        perm = np.argsort(spdf, kind="stable").astype(np.int32)
        bounds = np.searchsorted(spdf[perm], np.arange(self.num_pdfs + 1)
                                 ).astype(np.int32)
        return FactoredDenGraph(
            seg_bounds=np.asarray(self.seg_bounds, np.int32),
            state_pdf=np.asarray(self.state_pdf, np.int32),
            init=np.asarray(self.init, np.float32),
            final=np.asarray(self.final, np.float32),
            trans_pos=trans_pos, pdf_perm=perm, pdf_bounds=bounds,
            arc_dst=dst, arc_src_pos=srcp, arc_w=w, dst_bounds=starts,
            num_pdfs=self.num_pdfs)

    def to_blocked(self, superblocks: Optional[int] = None,
                   enter_pad: int = 4,
                   budget_entries: int = 96_000_000) -> BlockedDenGraph:
        """Host BlockedDenGraph (superblocked transition form).

        Discovers the source-class partition generically by union-find over
        sources sharing a destination position (for left-context
        compositions this recovers the "most recent phone" De Bruijn
        classes; ~47 at the flagship 4-gram x 6k-pdf scale), then merges the
        classes into ``superblocks`` balanced groups.  Every position's
        enter states are padded into runs of ``enter_pad`` (R); positions
        with more enters split into several subpositions carrying identical
        out-rows (their masses add, so the recursion is exact).  Topology
        self-loops fold into W as diagonal loop columns;
        ``wildcard_positions`` (identical-out-arc hubs of the committed +-1
        composition) become rank-R broadcast terms.  See
        `ops/fwdbwd.BlockedDenGraph` for the layout and per-frame recursion.
        Raises ValueError when the padded block volume exceeds
        ``budget_entries``.
        """
        r_pad = int(enter_pad)
        npos, s = self.num_positions, self.num_states
        seg = np.asarray(self.seg_bounds, np.int64)
        pos_of_state = np.zeros((s,), np.int64)
        for p in range(npos):
            pos_of_state[seg[p]: seg[p + 1]] = p
        loop_of = np.full((npos,), -1, np.int64)
        for pid, st in self.loop_state.items():
            loop_of[pid] = st
        src = np.asarray(self.arc_src_pos, np.int64)
        dst = np.asarray(self.arc_dst, np.int64)
        w = np.asarray(self.arc_w, np.float64)
        is_loop = dst == loop_of[src]
        wild = np.zeros((npos,), bool)
        if self.wildcard_positions:
            wild[np.asarray(self.wildcard_positions, np.int64)] = True
        blocked = ~is_loop & ~wild[src]
        bsrc, bdst_pos = src[blocked], pos_of_state[dst[blocked]]

        # ---- union-find: all (non-wildcard) sources of a dest position
        # share a class ----
        parent = np.arange(npos)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        order = np.argsort(bdst_pos, kind="stable")
        os_, od_ = bsrc[order], bdst_pos[order]
        dbounds = np.searchsorted(od_, np.arange(npos + 1))
        for d in range(npos):
            lo, hi = dbounds[d], dbounds[d + 1]
            if hi - lo > 1:
                rt = find(os_[lo])
                for x in os_[lo + 1: hi]:
                    parent[find(x)] = rt
        roots = np.array([find(i) for i in range(npos)])
        src_classes = np.unique(roots[np.unique(bsrc)]) if len(bsrc) else \
            np.array([0])
        class_of_root = {rt: i for i, rt in enumerate(src_classes)}
        raw_c = len(src_classes)

        src_class = np.full((npos,), -1, np.int64)
        has_blocked_out = np.zeros((npos,), bool)
        if len(bsrc):
            has_blocked_out[np.unique(bsrc)] = True
        for p in range(npos):
            if has_blocked_out[p]:
                src_class[p] = class_of_root[roots[p]]
        dst_class = np.full((npos,), -1, np.int64)
        for d in range(npos):
            lo, hi = dbounds[d], dbounds[d + 1]
            if hi > lo:
                dst_class[d] = class_of_root[roots[os_[lo]]]

        # ---- subposition counts (positions split into ceil(enters/R)) ----
        n_enter_pos = np.array(
            [(seg[p + 1] - seg[p]) - (loop_of[p] >= 0) for p in range(npos)],
            np.int64)
        n_sub_pos = np.maximum((n_enter_pos + r_pad - 1) // r_pad, 1)

        # ---- merge raw classes into balanced superblocks ----
        # Merging k classes into one superblock multiplies its padded area
        # by ~k (the block becomes [k*s, k*d]); it pays off only when raw
        # blocks are too small for the MXU (the flagship left-context
        # classes are 84x201 -> merge ~6x; the committed composition's
        # classes are already ~400 sources wide -> no merge).  Auto rule:
        # merge until ~512 source sub-slots per superblock.
        if superblocks is None:
            sbar = float(n_sub_pos.sum()) / max(raw_c, 1)
            mf = int(np.clip(round(512.0 / max(sbar, 1.0)), 1, raw_c))
            c_count = max(1, (raw_c + mf - 1) // mf)
        else:
            c_count = max(1, min(int(superblocks), raw_c))
        # per raw class: subposition load (sources assigned + dests assigned
        # track the same positions via different roles; balance on the sum)
        src_load = np.zeros((raw_c,), np.int64)
        dst_load = np.zeros((raw_c,), np.int64)
        for p in range(npos):
            if src_class[p] >= 0:
                src_load[src_class[p]] += n_sub_pos[p]
            if dst_class[p] >= 0:
                dst_load[dst_class[p]] += n_sub_pos[p]
        sb_of_class = np.zeros((raw_c,), np.int64)
        sb_load = np.zeros((c_count,), np.int64)
        for cls in np.argsort(-(src_load + dst_load)):
            sb = int(np.argmin(sb_load))
            sb_of_class[cls] = sb
            sb_load[sb] += src_load[cls] + dst_load[cls]
        src_sb = np.where(src_class >= 0, sb_of_class[src_class], -1)
        dst_sb = np.where(dst_class >= 0, sb_of_class[dst_class], -1)

        # greedy balance for unassigned positions (wildcards, hubs, BOS)
        fill = np.bincount(src_sb[src_sb >= 0],
                           weights=n_sub_pos[src_sb >= 0],
                           minlength=c_count)
        for p in range(npos):
            if src_sb[p] < 0:
                sb = int(np.argmin(fill))
                src_sb[p] = sb
                fill[sb] += n_sub_pos[p]
        fill = np.bincount(dst_sb[dst_sb >= 0],
                           weights=n_sub_pos[dst_sb >= 0],
                           minlength=c_count)
        for d in range(npos):
            if dst_sb[d] < 0:
                sb = int(np.argmin(fill))
                dst_sb[d] = sb
                fill[sb] += n_sub_pos[d]

        nsrc = int(np.bincount(src_sb, weights=n_sub_pos,
                               minlength=c_count).max())
        ndpos = int(np.bincount(dst_sb, weights=n_sub_pos,
                                minlength=c_count).max())
        ndp = r_pad * ndpos + nsrc
        if c_count * nsrc * ndp > budget_entries:
            raise ValueError(
                f"blocked den too large: {c_count} x {nsrc} x {ndp} "
                f"> {budget_entries} entries")

        # ---- slot layouts ----
        # source slots: per superblock, positions in id order, one slot per
        # subposition (consecutive)
        cs_total = c_count * nsrc
        sub0_src = np.full((npos,), -1, np.int64)  # first source slot
        fill = np.zeros((c_count,), np.int64)
        for p in range(npos):
            sb = src_sb[p]
            sub0_src[p] = sb * nsrc + fill[sb]
            fill[sb] += n_sub_pos[p]
        # dest subpositions: per superblock, positions in id order
        sub0_dst = np.full((npos,), -1, np.int64)  # first dest SUBPOS index
        fill = np.zeros((c_count,), np.int64)
        for d in range(npos):
            sb = dst_sb[d]
            sub0_dst[d] = sb * ndpos + fill[sb]
            fill[sb] += n_sub_pos[d]

        # enter slot of state = plane position inside its subposition run.
        # plane layout per superblock: [r_pad * ndpos enters | nsrc loops],
        # R-MAJOR (slot j*ndpos + sub): the per-subposition sums are then R
        # contiguous slices added together — no strided reshape, which the
        # fused Pallas scan kernel needs (ops/pallas_fwdbwd._blk_fwd_kernel)
        def enter_plane_slot(d, k):
            """k-th enter state of dest position d -> virtual plane index."""
            sub = sub0_dst[d] + k // r_pad
            sb, sub_in = divmod(sub, ndpos)
            return sb * ndp + (k % r_pad) * ndpos + sub_in

        def loop_plane_slot(p):
            slot = sub0_src[p]  # loop column on the FIRST source sub-slot
            sb, i = divmod(slot, nsrc)
            return sb * ndp + r_pad * ndpos + i

        enter_slot = np.full((s,), -1, np.int64)
        for d in range(npos):
            k = 0
            for st in range(seg[d], seg[d + 1]):
                if st == loop_of[d]:
                    continue
                enter_slot[st] = enter_plane_slot(d, k)
                k += 1

        state_pdf = np.asarray(self.state_pdf, np.int64)
        init = np.asarray(self.init, np.float64)
        final = np.asarray(self.final, np.float64)

        # ---- W blocks (enter arcs + diagonal loop columns) ----
        w_blocks = np.zeros((c_count, nsrc, ndp), np.float64)
        for a_i in np.nonzero(blocked)[0]:
            p, st, wt = src[a_i], dst[a_i], w[a_i]
            es = enter_slot[st]
            sb, j = divmod(es, ndp)
            assert sb == src_sb[p], "superblock mismatch"
            # identical rows for all of p's source sub-slots
            i0 = sub0_src[p] - sb * nsrc
            for i in range(i0, i0 + n_sub_pos[p]):
                w_blocks[sb, i, j] += wt
        for a_i in np.nonzero(is_loop)[0]:
            p, wt = src[a_i], w[a_i]
            sb, i0 = divmod(sub0_src[p], nsrc)
            # loop column only on the first sub-slot, but every sub-slot's
            # row must carry the arc (all of p's mass loops)
            for i in range(i0, i0 + n_sub_pos[p]):
                w_blocks[sb, i, r_pad * ndpos + i0] += wt

        # ---- wildcard broadcast groups (identical out-arc signatures) ----
        bcast_sel = bcast_vec = None
        wild_ids = np.nonzero(wild)[0]
        if len(wild_ids):
            groups: Dict[tuple, list] = {}
            arcs_by_src: Dict[int, list] = {int(p): [] for p in wild_ids}
            for a_i in np.nonzero(~is_loop & wild[src])[0]:
                arcs_by_src[int(src[a_i])].append(
                    (int(dst[a_i]), float(w[a_i])))
            for p, arcs in arcs_by_src.items():
                sig = tuple(sorted(arcs))
                groups.setdefault(sig, []).append(p)
            r_count = len(groups)
            bcast_sel = np.zeros((cs_total, r_count), np.float32)
            bcast_vec = np.zeros((r_count, c_count * ndp), np.float64)
            bcast_members = np.zeros((r_count,), np.float64)
            for gi, (sig, members) in enumerate(sorted(groups.items())):
                bcast_members[gi] = len(members)
                for p in members:
                    for i in range(n_sub_pos[p]):
                        bcast_sel[sub0_src[p] + i, gi] = 1.0
                for st, wt in sig:
                    bcast_vec[gi, enter_slot[st]] += wt

        # ---- virtual-axis vectors ----
        v_total = c_count * ndp
        pdf_v = np.zeros((v_total,), np.int32)
        init_v = np.zeros((v_total,), np.float64)
        final_v = np.zeros((v_total,), np.float64)
        state_to_virtual = np.full((s,), -1, np.int64)
        for st in range(s):
            if enter_slot[st] >= 0:
                state_to_virtual[st] = enter_slot[st]
        for p in range(npos):
            if loop_of[p] >= 0:
                state_to_virtual[loop_of[p]] = loop_plane_slot(p)
        assert (state_to_virtual >= 0).all(), "unmapped state"
        assert len(np.unique(state_to_virtual)) == s, "slot collision"
        pdf_v[state_to_virtual] = state_pdf
        init_v[state_to_virtual] = init
        final_v[state_to_virtual] = final

        # ---- per-sub-slot init sums (leaky-HMM target distribution) ----
        init_pos = np.zeros((cs_total,), np.float64)
        for p in range(npos):
            k = 0
            for st in range(seg[p], seg[p + 1]):
                sub = (0 if st == loop_of[p] else k // r_pad)
                init_pos[sub0_src[p] + sub] += init[st]
                if st != loop_of[p]:
                    k += 1

        # ---- permutation: source sub-slot -> dest subposition index ----
        # (pads point at the appended zero slot c_count*ndpos); the map is
        # injective on real entries, so the backward is a gather by the
        # inverse (sentinel cs_total = no source)
        perm = np.full((cs_total,), c_count * ndpos, np.int64)
        perm_inv = np.full((c_count * ndpos,), cs_total, np.int64)
        for p in range(npos):
            for i in range(n_sub_pos[p]):
                if n_enter_pos[p] > 0:
                    perm[sub0_src[p] + i] = sub0_dst[p] + i
                    perm_inv[sub0_dst[p] + i] = sub0_src[p] + i

        # ---- validation: per-state total in-weight conservation ----
        tot_ref = np.zeros((s,), np.float64)
        np.add.at(tot_ref, dst, w)
        # counting convention: an arc from position p contributes once per
        # source SUB-slot in w_blocks; divide back by the multiplicity
        mult = np.zeros((cs_total,), np.float64)
        for p in range(npos):
            mult[sub0_src[p]: sub0_src[p] + n_sub_pos[p]] = n_sub_pos[p]
        wsum = (w_blocks / np.maximum(
            mult.reshape(c_count, nsrc, 1), 1.0)).sum(axis=1).reshape(-1)
        tot_new = wsum.copy()
        if bcast_vec is not None:
            # one arc per member POSITION (sub-slot betas telescope)
            tot_new += (bcast_vec * bcast_members[:, None]).sum(axis=0)
        got = tot_new[state_to_virtual]
        if not np.allclose(got, tot_ref, rtol=1e-6, atol=1e-9):
            bad = np.argmax(np.abs(got - tot_ref))
            raise AssertionError(
                f"blocked export weight mismatch at state {bad}: "
                f"{got[bad]} vs {tot_ref[bad]}")

        return BlockedDenGraph(
            w_blocks=w_blocks.astype(np.float32),
            perm=perm.astype(np.int32),
            perm_inv=perm_inv.astype(np.int32),
            init_pos=init_pos.astype(np.float32),
            pdf_virtual=pdf_v,
            init_virtual=init_v.astype(np.float32),
            final_virtual=final_v.astype(np.float32),
            bcast_sel=bcast_sel,
            bcast_vec=(None if bcast_vec is None
                       else bcast_vec.astype(np.float32)),
            enter_pad=r_pad,
            num_states=s,
            num_pdfs=self.num_pdfs,
        )

    def init_lookup_seq(self, lm, phones) -> Tuple[np.ndarray, np.ndarray]:
        """(enter_init[i], loop_init[i]) den initial probs for the linear
        numerator chain of ``phones`` walked from BOS (the
        normalization-FST weights of upstream chain-supervision.cc)."""
        n = len(phones)
        e = np.zeros((n,), np.float32)
        l = np.zeros((n,), np.float32)
        pos = self.start_pos
        if self.committed:
            for i, q in enumerate(phones):
                r = int(phones[i + 1]) if i + 1 < n else -1
                k = (pos, int(q), r) if i == 0 else (pos, r)
                pos, pdf = self.pos_trans[k]
                e[i] = self.init[self.enter_state[(pos, pdf)]]
                l[i] = self.init[self.loop_state[pos]]
            return e, l
        for i, q in enumerate(phones):
            pos, pdf = self.pos_trans[(pos, int(q))]
            e[i] = self.init[self.enter_state[(pos, pdf)]]
            l[i] = self.init[self.loop_state[pos]]
        return e, l


def _lm_tables(lm):
    """(probs [NS,P], final [NS], next_state [NS,P], hist_of_state,
    bos_state) for either LM class (bigram PhoneLM is the 2-gram FSA)."""
    if isinstance(lm, NGramPhoneLM):
        return (np.asarray(lm.probs, np.float64),
                np.asarray(lm.final, np.float64),
                np.asarray(lm.next_state, np.int64),
                [tuple(h) for h in lm.hists],
                lm.walk_init())
    p = lm.num_phones
    probs = np.asarray(lm.probs, np.float64)  # [P+1, P], row 0 = BOS
    final = np.asarray(lm.final, np.float64)
    nxt = np.tile(np.arange(1, p + 1, dtype=np.int64)[None, :], (p + 1, 1))
    hists = [(q,) for q in range(-1, p)]
    return probs, final, nxt, hists, 0


def _compile_den_fsa_committed(lm, topo: ChainTopology, tree) -> CompiledDenFsa:
    """Composition variant for +-1 right-context trees (CrossTriphoneTree).

    A phone's forward pdf depends on its SUCCESSOR, so positions carry a
    *committed* next phone: position = (lm_state_after_q, extra_left, r)
    means "phone q = last of history is in progress, its successor is
    committed to be r" (r = -1: q ends the utterance — the wildcard/EOS
    commitment).  Arc weights pay the successor commitment probability
    P(r' | s·r) at commitment time, so every path's weight telescopes to
    the ordinary LM path probability; including the EOS-mass commitment
    (-1) makes each row exactly stochastic with no renormalization.
    Wildcard positions restart from the BOS distribution (utterance
    concatenation, the same chunk-interior semantics as the left-context
    composition's EOS redistribution).  The equivalent of Kaldi's
    C-transducer delayed-symbol composition in `chain-den-graph.cc` +
    `context-fst.cc`.
    """
    p_count = lm.num_phones
    if topo.num_phones != p_count:
        raise ValueError("phone count mismatch between LM and topology")
    a = float(topo.self_loop_prob)
    probs, lm_final, nxt, hists, bos = _lm_tables(lm)
    lm_final = np.maximum(lm_final, 1e-8)  # wildcard commitment weight floor

    pos_key: Dict[tuple, int] = {}
    pos_list: List[tuple] = []  # (lm_state, extra_left, committed_r)

    def pos_id(key) -> int:
        i = pos_key.get(key)
        if i is None:
            i = pos_key[key] = len(pos_list)
            pos_list.append(key)
        return i

    def dest_key(s2, full_left: tuple, r_new: int) -> tuple:
        """extra carries the left phone when the LM history is too short."""
        h2 = hists[s2]
        need = max(0, 1 - len(h2))
        e2 = full_left[len(full_left) - 1:] if need else ()
        return (s2, e2, r_new)

    start_id = pos_id((bos, (), -1))
    out_arcs: List[List[Tuple[int, int, float]]] = []
    enter_pdfs: List[List[int]] = []
    queue = [start_id]
    head = 0
    while head < len(queue):
        src = queue[head]
        head += 1
        while len(out_arcs) < len(pos_list):
            out_arcs.append(None)
            enter_pdfs.append([])
        s, extra, r = pos_list[src]
        fc = tuple(extra) + tuple(h for h in hists[s] if h != BOS)
        cur = fc[-1] if fc else -1  # phone in progress (left ctx of next)
        arcs = []

        def commit_arcs(s2, consumed: int, left: int, scale: float):
            """All successor commitments after consuming ``consumed``."""
            out = []
            for r2 in range(p_count):
                w = scale * float(probs[s2, r2])
                if w <= 0.0:
                    continue
                out.append((dest_key(s2, (consumed,), r2), consumed, left,
                            r2, w))
            w_end = scale * float(lm_final[s2])
            if w_end > 0.0:
                out.append((dest_key(s2, (consumed,), -1), consumed, left,
                            -1, w_end))
            return out

        if r != -1:
            # consume the committed phone r, choose its successor
            s2 = int(nxt[s, r])
            raw = commit_arcs(s2, r, cur, 1.0)
        else:
            # wildcard: current phone ended the utterance; restart from BOS
            raw = []
            norm = max(1.0 - float(lm_final[bos]), 1e-8)
            for q in range(p_count):
                wq = float(probs[bos, q]) / norm
                if wq <= 0.0:
                    continue
                raw.extend(commit_arcs(int(nxt[bos, q]), q, -1, wq))
        for key2, consumed, left, r2, w in raw:
            new = key2 not in pos_key
            d = pos_id(key2)
            if new:
                queue.append(d)
            pdf = int(tree.forward_pdf_lr(consumed, left, r2))
            while len(enter_pdfs) < len(pos_list):
                out_arcs.append(None)
                enter_pdfs.append([])
            if pdf not in enter_pdfs[d]:
                enter_pdfs[d].append(pdf)
            # walk key: wildcard sources need the consumed phone too
            wk = (src, consumed, r2) if r == -1 else (src, r2)
            arcs.append((d, pdf, (1.0 - a) * w, wk))
        out_arcs[src] = arcs

    npos = len(pos_list)
    seg_bounds = np.zeros((npos + 1,), np.int32)
    enter_state: Dict[Tuple[int, int], int] = {}
    loop_state: Dict[int, int] = {}
    state_pdf: List[int] = []
    sid = 0
    for pid in range(npos):
        seg_bounds[pid] = sid
        s, extra, r = pos_list[pid]
        fc = tuple(extra) + tuple(h for h in hists[s] if h != BOS)
        for pdf in sorted(enter_pdfs[pid]):
            enter_state[(pid, pdf)] = sid
            state_pdf.append(pdf)
            sid += 1
        if fc:
            loop_state[pid] = sid
            state_pdf.append(int(tree.self_loop_pdf(fc[-1])))
            sid += 1
    seg_bounds[npos] = sid
    num_states = sid

    arc_dst: List[int] = []
    arc_src_pos: List[int] = []
    arc_w: List[float] = []
    pos_trans = {}
    for pid in range(npos):
        lp = loop_state.get(pid)
        if lp is not None:
            arc_dst.append(lp)
            arc_src_pos.append(pid)
            arc_w.append(a)
        for d, pdf, w, wk in out_arcs[pid]:
            arc_dst.append(enter_state[(d, pdf)])
            arc_src_pos.append(pid)
            arc_w.append(w)
            pos_trans[wk] = (d, pdf)
    arc_dst = np.asarray(arc_dst, np.int32)
    arc_src_pos = np.asarray(arc_src_pos, np.int32)
    arc_w = np.asarray(arc_w, np.float32)

    # stationary init, iteration-averaged (fsa.stationary_init semantics)
    w64 = arc_w.astype(np.float64)
    alpha = np.zeros((num_states,), np.float64)
    for d, pdf, w, _wk in out_arcs[start_id]:
        alpha[enter_state[(d, pdf)]] += w
    alpha /= max(alpha.sum(), 1e-30)
    acc = alpha.copy()
    for _ in range(100):
        beta = np.add.reduceat(
            np.concatenate([alpha, [0.0]]),
            np.minimum(seg_bounds[:-1], num_states).astype(np.int64),
        )
        empty = seg_bounds[:-1] == seg_bounds[1:]
        beta = np.where(empty, 0.0, beta[: npos])
        nxt_alpha = np.zeros((num_states,), np.float64)
        np.add.at(nxt_alpha, arc_dst, beta[arc_src_pos] * w64)
        tot = nxt_alpha.sum()
        if tot <= 0:
            raise ValueError("denominator FSA has no probability mass")
        alpha = nxt_alpha / tot
        acc += alpha
    init = (acc / acc.sum()).astype(np.float32)

    fsa = CompiledDenFsa(
        num_positions=npos,
        num_states=num_states,
        num_pdfs=tree.num_pdfs,
        seg_bounds=seg_bounds,
        state_pdf=np.asarray(state_pdf, np.int32),
        arc_dst=arc_dst,
        arc_src_pos=arc_src_pos,
        arc_w=arc_w,
        init=init,
        final=np.ones((num_states,), np.float32),
        enter_state=enter_state,
        loop_state=loop_state,
        start_pos=start_id,
        pos_trans=pos_trans,
    )
    fsa.committed = True
    # wildcard (EOS-commitment) positions share one identical out-arc list
    # spanning all consumed-phone classes — the blocked kernel factors them
    # as a rank-1 broadcast term instead of letting them merge the classes
    fsa.wildcard_positions = [
        pid for pid, key in enumerate(pos_list) if key[2] == -1]
    return fsa


def compile_denominator_fsa(lm, topo: ChainTopology, tree) -> CompiledDenFsa:
    """Compose phone LM x chain topology x context tree into the factored
    state-emitting den FSA.

    Positions are (LM state, extra left context) pairs — ``extra`` carries
    just enough phones beyond the LM history for the tree's left context
    (``tree.context_width - 1``).  Each position owns one state per distinct
    forward pdf it is entered with, plus one self-loop state.  BOS-context
    positions exist (the numerator walk needs their keys) but get zero
    stationary mass, matching the round-1 dense layout's unreachable BOS
    rows.
    """
    if getattr(tree, "right_context", 0):
        return _compile_den_fsa_committed(lm, topo, tree)
    p_count = lm.num_phones
    if topo.num_phones != p_count:
        raise ValueError("phone count mismatch between LM and topology")
    a = float(topo.self_loop_prob)
    tctx = tree.context_width - 1
    probs, lm_final, nxt, hists, bos = _lm_tables(lm)

    def mk_start():
        h = hists[bos]
        need = max(0, tctx - len(h))
        return (bos, (BOS,) * need)

    pos_key: Dict[tuple, int] = {}
    pos_list: List[tuple] = []

    def pos_id(key) -> int:
        i = pos_key.get(key)
        if i is None:
            i = pos_key[key] = len(pos_list)
            pos_list.append(key)
        return i

    start = mk_start()
    start_id = pos_id(start)
    # discovery: per-position out-arcs (dest_pos, pdf, weight) and the set
    # of enter pdfs per position
    out_arcs: List[List[Tuple[int, int, float]]] = []
    enter_pdfs: List[List[int]] = []
    pos_norm: Dict[int, float] = {}
    queue = [start_id]
    head = 0
    while head < len(queue):
        src = queue[head]
        head += 1
        while len(out_arcs) < len(pos_list):
            out_arcs.append(None)
            enter_pdfs.append([])
        s, extra = pos_list[src]
        h = hists[s]
        fc = tuple(extra) + tuple(h)  # most-recent-last
        left = tuple(reversed(fc))[:tctx]  # most-recent-first for the tree
        # row-normalize like the dense builder: the LM's end-of-sequence
        # mass is redistributed so every den row is stochastic (chunks are
        # cut mid-utterance; all states are final with weight 1)
        norm = a + (1.0 - a) * (1.0 - float(lm_final[s]))
        pos_norm[src] = norm
        arcs = []
        for q in range(p_count):
            w = float(probs[s, q]) / norm
            s2 = int(nxt[s, q])
            h2 = hists[s2]
            full = fc + (q,)
            need = max(0, tctx - len(h2))
            cut = len(full) - len(h2)
            e2 = full[cut - need: cut]
            key2 = (s2, e2)
            new = key2 not in pos_key
            d = pos_id(key2)
            if new:
                queue.append(d)
            pdf = int(tree.forward_pdf_ctx(q, left))
            while len(enter_pdfs) < len(pos_list):
                out_arcs.append(None)
                enter_pdfs.append([])
            if pdf not in enter_pdfs[d]:
                enter_pdfs[d].append(pdf)
            arcs.append((d, pdf, (1.0 - a) * w))
        out_arcs[src] = arcs

    npos = len(pos_list)
    # state layout: per position, its enter splits (sorted) then its loop
    # state; BOS-phone positions own no states (empty segment)
    seg_bounds = np.zeros((npos + 1,), np.int32)
    enter_state: Dict[Tuple[int, int], int] = {}
    loop_state: Dict[int, int] = {}
    state_pdf: List[int] = []
    sid = 0
    for pid in range(npos):
        seg_bounds[pid] = sid
        s, _ = pos_list[pid]
        phone = hists[s][-1]
        for pdf in sorted(enter_pdfs[pid]):
            enter_state[(pid, pdf)] = sid
            state_pdf.append(pdf)
            sid += 1
        if phone != BOS:
            loop_state[pid] = sid
            state_pdf.append(int(tree.self_loop_pdf(phone)))
            sid += 1
    seg_bounds[npos] = sid
    num_states = sid

    # factored arcs (dest state <- source position)
    arc_dst: List[int] = []
    arc_src_pos: List[int] = []
    arc_w: List[float] = []
    for pid in range(npos):
        lp = loop_state.get(pid)
        if lp is not None:
            arc_dst.append(lp)
            arc_src_pos.append(pid)
            arc_w.append(a / pos_norm[pid])
        for d, pdf, w in out_arcs[pid]:
            arc_dst.append(enter_state[(d, pdf)])
            arc_src_pos.append(pid)
            arc_w.append(w)
    arc_dst = np.asarray(arc_dst, np.int32)
    arc_src_pos = np.asarray(arc_src_pos, np.int32)
    arc_w = np.asarray(arc_w, np.float32)

    # init by factored power iteration from the BOS state, AVERAGED over
    # iterations (Kaldi chain-den-graph.cc SetInitialProbs semantics):
    # utterance-early states keep ~1/iters mass so
    # numerator chunks cut at utterance starts have nonzero initial weight
    w64 = arc_w.astype(np.float64)
    alpha = np.zeros((num_states,), np.float64)
    for d, pdf, w in out_arcs[start_id]:  # one LM step from BOS
        alpha[enter_state[(d, pdf)]] += w
    alpha /= max(alpha.sum(), 1e-30)
    acc = alpha.copy()
    for _ in range(100):
        beta = np.add.reduceat(
            np.concatenate([alpha, [0.0]]),
            np.minimum(seg_bounds[:-1], num_states).astype(np.int64),
        )
        # reduceat quirk: empty segments (start == next start) return the
        # element at start instead of 0 — fix by masking
        empty = seg_bounds[:-1] == seg_bounds[1:]
        beta = np.where(empty, 0.0, beta[: npos])
        nxt_alpha = np.zeros((num_states,), np.float64)
        np.add.at(nxt_alpha, arc_dst, beta[arc_src_pos] * w64)
        tot = nxt_alpha.sum()
        if tot <= 0:
            raise ValueError("denominator FSA has no probability mass")
        alpha = nxt_alpha / tot
        acc += alpha
    init = (acc / acc.sum()).astype(np.float32)

    pos_trans = {}
    for pid in range(npos):
        for q, (d, pdf, _) in enumerate(out_arcs[pid]):
            pos_trans[(pid, q)] = (d, pdf)

    return CompiledDenFsa(
        num_positions=npos,
        num_states=num_states,
        num_pdfs=tree.num_pdfs,
        seg_bounds=seg_bounds,
        state_pdf=np.asarray(state_pdf, np.int32),
        arc_dst=arc_dst,
        arc_src_pos=arc_src_pos,
        arc_w=arc_w,
        init=init,
        final=np.ones((num_states,), np.float32),
        enter_state=enter_state,
        loop_state=loop_state,
        start_pos=start_id,
        pos_trans=pos_trans,
    )


def _build_biphone(lm: PhoneLM, topo: ChainTopology, tree: BiphoneTree) -> StateGraph:
    """Left-biphone dense den: enter states per (left in -1..P-1, phone),
    then one loop state per phone, S = P*(P+1) + P."""
    p_count = lm.num_phones
    a = topo.self_loop_prob

    def enter_idx(left: int, phone: int) -> int:
        return (left + 1) * p_count + phone

    n_enter = (p_count + 1) * p_count
    s = n_enter + p_count
    loop0 = n_enter
    trans = np.zeros((s, s), dtype=np.float64)
    state_pdf = np.zeros((s,), dtype=np.int32)
    for left in range(-1, p_count):
        for p in range(p_count):
            state_pdf[enter_idx(left, p)] = tree.forward_pdf(p, left)
    for p in range(p_count):
        state_pdf[loop0 + p] = tree.self_loop_pdf(p)
    lmp = lm.probs.astype(np.float64)
    for p in range(p_count):
        srcs = [enter_idx(left, p) for left in range(-1, p_count)] + [loop0 + p]
        for src in srcs:
            trans[src, loop0 + p] += a
            for q in range(p_count):
                trans[src, enter_idx(p, q)] += (1.0 - a) * lmp[p + 1, q]
    g = StateGraph(
        trans=trans.astype(np.float32),
        state_pdf=state_pdf,
        init=np.full((s,), 1.0 / s, dtype=np.float32),
        final=np.ones((s,), dtype=np.float32),
        num_pdfs=tree.num_pdfs,
    ).normalize()
    start = np.zeros((s,), np.float64)
    for q in range(p_count):
        start[enter_idx(-1, q)] = lmp[0, q]  # BOS row
    g = StateGraph(
        trans=g.trans,
        state_pdf=g.state_pdf,
        init=stationary_init(g.trans, start=start, average=True),
        final=g.final,
        num_pdfs=g.num_pdfs,
    )
    g.validate()
    return g


def random_blocked_graph(rng, c, nsrc, ndpos, r, num_pdfs, groups=0):
    """A random graph in the blocked layout (C superblocks, NSRC source
    and NDPOS enter positions, R enter slots each, num_pdfs pdfs): injective
    perm with pad source slots, row-stochastic W rows, zero columns on
    unused enter slots; with ``groups`` > 0 a wildcard term of that many
    groups over a tenth of the source slots, whose W rows then carry half
    their mass and the group's out-row the other half.  For the kernels'
    tests and tools."""
    ndp = r * ndpos + nsrc
    cs, cnd = c * nsrc, c * ndpos
    perm = np.full(cs, cnd, np.int64)
    src = rng.permutation(cs)[: min(cs, cnd) * 9 // 10]
    dst = rng.permutation(cnd)[: len(src)]
    perm[src] = dst
    perm_inv = np.full(cnd, cs, np.int64)
    perm_inv[dst] = src
    w = rng.rand(c, nsrc, ndp) * (rng.rand(c, nsrc, ndp) < 0.3)
    w[:, :, : r * ndpos] *= (rng.rand(r * ndpos) < 0.8)  # unused slots
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-9)
    v = c * ndp
    sel = vec = None
    if groups:
        members = rng.permutation(cs)[: max(groups, cs // 10)]
        sel = np.zeros((cs, groups), np.float32)
        sel[members, np.arange(len(members)) % groups] = 1.0
        w.reshape(cs, ndp)[members] *= 0.5
        vec = rng.rand(groups, v) * (rng.rand(groups, v) < 0.3)
        vec = (0.5 * vec / vec.sum(-1, keepdims=True)).astype(np.float32)
    init_v = rng.rand(v) * (w.sum(1).reshape(-1) > 0)
    return BlockedDenGraph(
        w_blocks=w.astype(np.float32), perm=perm.astype(np.int32),
        perm_inv=perm_inv.astype(np.int32),
        init_pos=rng.rand(cs).astype(np.float32) / cs,
        pdf_virtual=rng.randint(0, num_pdfs, v).astype(np.int32),
        init_virtual=(init_v / init_v.sum()).astype(np.float32),
        final_virtual=np.ones(v, np.float32),
        bcast_sel=sel, bcast_vec=vec, enter_pad=r, num_states=v,
        num_pdfs=num_pdfs)
