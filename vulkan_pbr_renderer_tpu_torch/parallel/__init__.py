"""Multi-GPU execution of the frame on torch.distributed."""
