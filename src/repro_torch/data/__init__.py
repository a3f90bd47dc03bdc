from repro_torch.data.pipeline import (
    DataState,
    ShardedTokenPipeline,
    TokenDataset,
    global_batch_specs,
)

__all__ = ["DataState", "ShardedTokenPipeline", "TokenDataset",
           "global_batch_specs"]
