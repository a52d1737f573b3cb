from .pipeline import PackedFileDataset, Prefetcher, SyntheticLM, make_batches

__all__ = ["PackedFileDataset", "Prefetcher", "SyntheticLM", "make_batches"]
