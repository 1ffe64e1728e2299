from .pipeline import ShardedLoader, SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "ShardedLoader", "make_batch_iterator"]
