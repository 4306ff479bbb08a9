"""Paths through parameter trees: nested dicts and lists of tensors, walked
as ``jax.tree_util`` walks them (dict keys in sorted order, list entries in
index order), so every family's parameters, whatever their depth (the
real families' ``{layer: {w, b}}``, mscale_2's combiner with a tensor
beside ``{w, b}`` dicts, mscale_hier's ``stages[k][i]`` lists), go through
one walk.

A path is a tuple of dict keys (str) and list indices (int); a leaf is
anything that is neither a dict nor a list/tuple.
"""
from __future__ import annotations


def leaves(tree, prefix=()):
    """[(path, leaf)] in jax.tree_util's order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def unflatten(paths, values):
    """The tree whose leaf at each path is the matching value: str keys
    build dicts, int keys lists (indices 0 .. k-1, all present)."""
    paths = list(paths)
    values = list(values)
    if not paths:
        return {}
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    groups = {}
    for path, v in zip(paths, values):
        if not path:
            raise ValueError("a root leaf beside other leaves")
        groups.setdefault(path[0], []).append((path[1:], v))
    sub = {k: unflatten([p for p, _ in g], [v for _, v in g])
           for k, g in groups.items()}
    if all(isinstance(k, int) for k in sub):
        if sorted(sub) != list(range(len(sub))):
            raise ValueError(f"list indices {sorted(sub)} are not 0 .. "
                             f"{len(sub) - 1}")
        return [sub[i] for i in range(len(sub))]
    if any(isinstance(k, int) for k in sub):
        raise ValueError("a node with both list indices and dict keys")
    return sub


def map(fn, tree):
    """The tree of ``fn(leaf)``, same structure."""
    flat = leaves(tree)
    return unflatten([p for p, _ in flat], [fn(v) for _, v in flat])


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def stage_of(path):
    """The first list index on a path, or 0 where there is none: the
    per-stage learning-rate group of a leaf (wire_tpu/train/trainer.py:
    make_optimizer's label_tree)."""
    for k in path:
        if isinstance(k, int):
            return k
    return 0


def stack(trees):
    """One tree whose leaves stack the given trees' leaves along a new
    leading replica axis (``jax.tree.map(lambda *x: jnp.stack(x), *trees)``);
    the trees share one structure."""
    import torch
    flats = [leaves(t) for t in trees]
    paths = [p for p, _ in flats[0]]
    for flat in flats[1:]:
        if [p for p, _ in flat] != paths:
            raise ValueError("stack: the trees differ in structure")
    return unflatten(paths, [torch.stack([flat[i][1] for flat in flats])
                             for i in range(len(paths))])


def index(tree, r):
    """Replica r of a replica-stacked tree (every leaf's ``x[r]``)."""
    return map(lambda x: x[r], tree)


def replicas(tree):
    """M, the leading axis shared by every leaf of a replica-stacked tree
    (raises when the leaves disagree)."""
    sizes = {t.shape[0] if t.ndim else None for _, t in leaves(tree)}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"a replica stack needs one leading axis on every "
                         f"leaf, got leading sizes "
                         f"{sorted(str(s) for s in sizes)}")
    return sizes.pop()


def replica(x, r, M):
    """Replica r of M: a shared tensor (None, or 2-D: rows x columns) is
    itself; any other is per replica, ``x[r]``, and must have the leading
    axis M (raises otherwise).  A batch of rows shared by the replicas is
    therefore passed flat (rows, d) or expanded to (M, ..., rows, d)."""
    if x is None or x.ndim == 2:
        return x
    if x.shape[0] != M:
        raise ValueError(f"a per-replica tensor of {M} replicas needs the "
                         f"leading axis {M}, got {tuple(x.shape)}; shared "
                         f"rows are 2-D (rows, columns)")
    return x[r]


def replica_axis(x, M):
    """The axis of ``x`` that ``torch.func.vmap`` maps over M replicas:
    None for a shared tensor (None, or 2-D), else 0, after the check of
    ``replica`` (a per-replica tensor leads with M; raises otherwise)."""
    if x is None or x.ndim == 2:
        return None
    replica(x, 0, M)
    return 0


def unstack(tree):
    """The list of a replica-stacked tree's replicas."""
    flat = leaves(tree)
    return [index(tree, r) for r in range(len(flat[0][1]))] if flat else []
