from repro_torch.data.pipeline import TokenPipeline, make_lm_batch
from repro_torch.data.synthetic import ManyClassDataset

__all__ = ["TokenPipeline", "make_lm_batch", "ManyClassDataset"]
