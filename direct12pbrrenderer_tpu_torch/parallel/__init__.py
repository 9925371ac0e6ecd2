"""Multi-GPU frame rendering (`frame_sharded`): row bands over torch.distributed."""
