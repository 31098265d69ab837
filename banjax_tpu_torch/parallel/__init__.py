"""The device mesh: the batched NFA match sharded over a grid of devices."""
