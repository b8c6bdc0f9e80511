"""Feature front end: fbank / MFCC, CMVN, speed perturbation,
SpecAugment (port of ``tdnnf_nas_tpu.frontend``)."""
from tdnnf_nas_torch.frontend.features import (FbankConfig, FrontendConfig,
                                               MfccConfig, cmvn,
                                               compute_fbank, compute_mfcc,
                                               frame_signal, mel_filterbank,
                                               num_frames, sliding_cmn)
from tdnnf_nas_torch.frontend.speed_perturb import speed_perturb
