from repro_torch.checkpoint.manager import (CheckpointManager, restore_tree,
                                            save_tree)
