"""Sharded demod over a ("channel", "time") mesh (`sharded`) and the
streaming multi-process pipeline on `torch.distributed` (`multihost`)."""
