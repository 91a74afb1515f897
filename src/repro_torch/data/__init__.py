from repro_torch.data.pipeline import (Prefetcher, RankBatch,  # noqa: F401
                                     SyntheticLMData, batch_specs,
                                     shard_batch)
