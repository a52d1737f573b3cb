from .store import (AsyncCheckpointer, latest_step, restore_checkpoint,
                    save_checkpoint, tree_leaves, tree_unflatten)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "tree_leaves", "tree_unflatten"]
