from .pipeline import SyntheticLM, dataset_for, make_batch, place_batch

__all__ = ["SyntheticLM", "make_batch", "place_batch", "dataset_for"]
