"""The GMM bootstrap ladder (port of ``tdnnf_nas_tpu.gmm``)."""
from tdnnf_nas_torch.gmm.gmm import (
    AmGmm,
    DiagGmm,
    MonoHmmConfig,
    corpus_loglike,
    train_mono,
    train_tri,
    viterbi_align_gmm,
)
from tdnnf_nas_torch.gmm.ladder import (GmmLadderConfig, GmmLadderResult,
                                        run_gmm_ladder)
from tdnnf_nas_torch.gmm.transforms import (
    apply_fmllr,
    estimate_fmllr,
    estimate_lda,
    estimate_mllt,
    splice_frames,
)
