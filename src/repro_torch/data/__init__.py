from .gnn_data import FullBatchTask, make_task, split_masks, partition_task

__all__ = ["FullBatchTask", "make_task", "split_masks", "partition_task"]
