"""Tiny AST helpers shared by the rule families.

Port of ``predictionio_tpu/analysis/astutil.py``."""

from __future__ import annotations

import ast
from typing import Iterator


def dotted(node: ast.AST) -> str | None:
    """``jax.experimental.shard_map`` for a Name/Attribute chain, else None."""
    # bare Name and one-level Attribute cover most call sites; this runs
    # hundreds of thousands of times per sweep, so skip the list+join
    # machinery for them
    if isinstance(node, ast.Name):
        return node.id
    if not isinstance(node, ast.Attribute):
        return None
    value = node.value
    if isinstance(value, ast.Name):
        return f"{value.id}.{node.attr}"
    parts: list[str] = [node.attr]
    node = value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return ".".join(parts)
    return None


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for child in ast.walk(node):
        if isinstance(child, ast.Call):
            yield child


def names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def call_name(call: ast.Call) -> str:
    return dotted(call.func) or ""


def const_strings(node: ast.AST) -> set[str]:
    return {
        c.value
        for c in ast.walk(node)
        if isinstance(c, ast.Constant) and isinstance(c.value, str)
    }


def keyword(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def func_defs(tree: ast.AST) -> dict[str, list[ast.FunctionDef]]:
    """All function defs in the module, keyed by bare name (nested included)."""
    out: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out
