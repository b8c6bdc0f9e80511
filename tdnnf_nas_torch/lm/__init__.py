"""Language models (port of ``tdnnf_nas_tpu.lm``): the backoff n-gram
(numpy) and the RNNLM (``lm/rnnlm``, torch)."""
from tdnnf_nas_torch.lm.ngram import NGramLM, estimate_ngram_lm
