"""Language models (copy of ``tdnnf_nas_tpu.lm``): the backoff n-gram.
The RNNLM (``lm/rnnlm``) waits for a later slice."""
from tdnnf_nas_torch.lm.ngram import NGramLM, estimate_ngram_lm
