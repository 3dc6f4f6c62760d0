"""Nested-tuple container algebra over tensors (port of
svae_tpu/utils/pytree.py). Natural parameters and statistics are nested
tuples whose leaves are tensors or Python numbers."""


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over congruent nested tuples/lists."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *sub) for sub in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """Leaves of a nested tuple, depth first."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: s * x, a)


def tree_dot(a, b):
    """Full inner product <a, b> across two congruent trees."""
    return sum((x * y).sum() for x, y in zip(tree_leaves(a), tree_leaves(b)))
