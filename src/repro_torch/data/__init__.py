from .pipeline import SyntheticLM, Prefetcher, make_pipeline, shard_for_host
