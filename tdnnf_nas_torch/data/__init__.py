"""Host-side data: synthetic corpus and egs (numpy copies)."""
from tdnnf_nas_torch.data.egs import Chunk, EgsConfig, batch_iterator, make_egs
from tdnnf_nas_torch.data.synthetic import (SyntheticCorpusConfig,
                                            make_synthetic_corpus)
