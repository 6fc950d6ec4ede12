from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: F401
