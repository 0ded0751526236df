from repro_torch.data.pipeline import (FsShardReader, Prefetcher,
                                       SyntheticLM, write_shards)

__all__ = ["FsShardReader", "Prefetcher", "SyntheticLM", "write_shards"]
