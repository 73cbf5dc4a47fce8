from .gnn_data import FullBatchTask, make_task, split_masks, partition_task
from .token_stream import TokenStream, synthetic_token_batches

__all__ = ["FullBatchTask", "make_task", "split_masks", "partition_task",
           "TokenStream", "synthetic_token_batches"]
