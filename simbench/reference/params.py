"""The initial parameters a run starts from, made by the benchmark.

``make_units(ref, arch, seed, device)`` draws one model's cuttable units,
laid out as the configuration's reference module says (``ref.leaf_specs``:
the unit list the simulator trains, in its sorted-key order), from
``seed`` on ``device`` in one call of a generator on that device, in the
type each leaf is trained in.  The program and the reference are both
handed these units.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _drawn(init) -> bool:
    return isinstance(init, (int, float))


def make_units(ref, arch, seed: int, device) -> list:
    """The unit list of one model, drawn from ``seed`` on ``device``: one
    normal draw for every leaf whose ``init`` is a standard deviation, in
    the layout's order; ``"zeros"``, ``"ones"`` and a module's own
    ``init(shape, dtype, device)`` draw nothing."""
    specs = ref.leaf_specs(arch)
    drawn = [s for s in specs if _drawn(s[4])]
    total = sum(math.prod(s[2]) for s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    units = [{} for _ in range(specs[-1][0] + 1)]
    off = 0
    for u, path, shape, dtype, init in specs:
        if init == "zeros":
            leaf = torch.zeros(shape, dtype=DTYPES[dtype], device=device)
        elif init == "ones":
            leaf = torch.ones(shape, dtype=DTYPES[dtype], device=device)
        elif _drawn(init):
            n = math.prod(shape)
            leaf = (flat[off:off + n].view(shape) * init).to(DTYPES[dtype])
            off += n
        else:
            leaf = init(shape, DTYPES[dtype], device)
        node = units[u]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    del flat
    return units


def leaves(tree) -> list:
    """A unit tree's leaves in sorted-key order (the simulator's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of `leaves`, in the same order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]
