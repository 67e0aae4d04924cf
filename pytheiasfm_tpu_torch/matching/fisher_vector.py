"""Fisher-vector global descriptors: a stub, as in the reference.

Counterpart of the JAX package's `matching/fisher_vector.py`. The reference
removed its VLFeat GMM backend and `FisherVectorExtractor::Train()` fails
unconditionally (`theia/matching/fisher_vector_extractor.cc:50-52`); global
descriptors come from Python models instead (CosPlace in
`pyexamples/sfm_pipeline_loftr_aqualoc.py:203`). Construction succeeds;
training and extraction raise.
"""

from __future__ import annotations

__all__ = ["FisherVectorExtractor"]


class FisherVectorExtractor:
    """Parity: `theia::FisherVectorExtractor` (stubbed)."""

    class Options:
        num_gmm_clusters: int = 16
        max_num_features_for_training: int = 100000

    def __init__(self, options: "FisherVectorExtractor.Options" = None):
        self.options = options or FisherVectorExtractor.Options()

    def train(self, *_args, **_kwargs):
        raise NotImplementedError(
            "FisherVectorExtractor is stubbed (as in the reference, "
            "fisher_vector_extractor.cc:50-52); use a learned global "
            "descriptor (e.g. CosPlace) and `matching.graph_match` instead."
        )

    def extract_global_descriptor(self, *_args, **_kwargs):
        raise NotImplementedError("FisherVectorExtractor is stubbed; see train().")
