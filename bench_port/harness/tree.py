"""Leaf-wise operations on a world state: a tree of dataclasses (and
NamedTuples) whose leaves are tensors. Written against field names only,
so they serve any state tree of the port."""

from __future__ import annotations

import dataclasses

import torch


def leaves(tree, prefix="") -> dict:
    """{dotted path: tensor} of every tensor leaf (None leaves skipped)."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(leaves(getattr(tree, f.name), prefix + f.name + "."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree
    return out


def tmap(fn, tree):
    """The tree with fn applied to every tensor leaf."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tmap(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def clone(tree):
    return tmap(torch.clone, tree)


def replace_leaf(tree, path: str, value):
    """A copy of the tree (sharing every other leaf) with the leaf at
    the dotted path replaced."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(tree, **{head: value})
    return dataclasses.replace(
        tree, **{head: replace_leaf(getattr(tree, head), rest, value)})
