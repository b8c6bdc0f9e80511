"""Decoding (port of ``tdnnf_nas_tpu.decode``): Viterbi on the card, the
sparse-HCLG beam search, lattices, n-gram and RNNLM rescoring and
scoring on the host (the RNNLM's steps on its own device).  The
reference's exports."""
from tdnnf_nas_torch.decode.viterbi import viterbi_decode, path_to_phones
from tdnnf_nas_torch.decode.scoring import edit_distance, wer, score_corpus
from tdnnf_nas_torch.decode.wfst import (
    Lexicon,
    WordLM,
    estimate_word_lm,
    build_decoding_graph,
    decode_words,
    path_to_words,
)
from tdnnf_nas_torch.decode.lattice import (
    Lattice,
    generate_lattice,
    lattice_best_path,
    lattice_nbest,
    lattice_arc_posteriors,
    lattice_oracle_wer,
    rescore_lattice,
    rescore_lattice_rnnlm,
)
