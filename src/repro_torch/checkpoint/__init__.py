from .checkpointing import Checkpointer, keyed_leaves, latest_step, restore, save

__all__ = ["Checkpointer", "keyed_leaves", "latest_step", "restore", "save"]
