"""Sweep files with the reference's cw2 semantics.

Counterpart of ``beyond_deep_ensembles_tpu/utils/config.py``: a
multi-document YAML sweep, a ``DEFAULT`` document with shared ``params``,
one named document per variant merged over it, a ``list`` key whose value
lists are zipped, a ``grid`` key whose value lists are crossed, and
``repetitions``. :func:`load_sweep` parses the file with PyYAML (imported
when it is called, so that the package imports without it) and hands the
documents to :func:`expand_sweep`, which takes them already parsed.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Iterator, List, Optional


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def expand_config(doc: dict) -> List[dict]:
    """One experiment document -> its concrete ``params`` dicts: ``grid:``
    crossed first, then ``list:`` zipped positionally (equal lengths), each
    merged into ``params``."""
    variants = [dict(doc.get("params", {}))]

    grid = doc.get("grid")
    if grid:
        names = list(grid.keys())
        variants = [
            _deep_merge(v, dict(zip(names, combo)))
            for v in variants
            for combo in itertools.product(*[grid[k] for k in names])
        ]

    zipped = doc.get("list")
    if zipped:
        names = list(zipped.keys())
        lengths = {len(zipped[k]) for k in names}
        assert len(lengths) == 1, f"'list' entries must have equal length: {zipped}"
        # the length taken once: the JAX package pops it inside the loop,
        # which a ``grid`` of more than one point exhausts (KeyError)
        length = lengths.pop()
        variants = [_deep_merge(v, {k: zipped[k][i] for k in names}) for v in variants for i in range(length)]
    return variants


def expand_sweep(docs: Iterable[Optional[dict]], name: Optional[str] = None) -> Iterator[dict]:
    """Parsed sweep documents -> ``{"name", "variant", "repetitions",
    "params"}`` per concrete run, the ``DEFAULT`` document merged under every
    named one (``SLURM`` and unnamed documents skipped), only the variant
    ``name`` where given."""
    docs = [d for d in docs if d]
    default = next((d for d in docs if d.get("name") == "DEFAULT"), {})
    for d in docs:
        if d.get("name") in (None, "DEFAULT", "SLURM"):
            continue
        if name is not None and d["name"] != name:
            continue
        merged = _deep_merge(default, d)
        for i, params in enumerate(expand_config(merged)):
            yield {"name": d["name"], "variant": i, "repetitions": merged.get("repetitions", 1), "params": params}


def load_sweep(path: str, name: Optional[str] = None) -> Iterator[dict]:
    """A multi-document YAML sweep file, parsed by PyYAML, through
    :func:`expand_sweep`."""
    import yaml

    with open(path) as f:
        docs = list(yaml.safe_load_all(f))
    return expand_sweep(docs, name=name)
