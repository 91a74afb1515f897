from repro_torch.data.pipeline import Prefetcher, SyntheticLMData, shard_batch
