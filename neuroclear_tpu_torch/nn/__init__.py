"""Layer, norm and generator twins of ``neuroclear_tpu/nn``."""
