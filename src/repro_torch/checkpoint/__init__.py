from .manager import CheckpointManager, latest_step, restore_tree, save_tree

__all__ = ["CheckpointManager", "save_tree", "restore_tree", "latest_step"]
