from repro_torch.utils.tree import (map_leaves, param_count,  # noqa: F401
                                    tree_bytes, tree_leaves, tree_map)
