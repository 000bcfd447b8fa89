"""Shared leaf classification for the federated stack (a copy of
``repro.federated.leaves``; the port imports nothing of ``repro``).

Every piece of FL machinery that walks a parameter tree — update masks
(``masks.py``), analytic communication accounting (``comm.py``) and the
wire-level transport (``transport.py``) — must agree on what each leaf *is*:

  stacked   a per-stage block stack (leading dim = stage axis); the round
            plan's ``[lo, hi)`` stage range selects rows of it.
  embed     input-side parameters (token/patch embeddings, positional
            embeddings, CLS token, LM head): trainable / exchanged only
            when the stage prefix is active (``active_from == 0``).
  head      SSL projection & prediction MLPs: always trained locally;
            exchanged by default. ``include_heads=False`` drops them from
            both comm accounting and the wire (encoder-only exchange);
            note the single-copy simulator then discards local head
            training each round rather than persisting per-client heads.
  extra     everything else that travels with the encoder whenever any
            stage moves (final norm, Zamba's shared attention block, conv
            stubs): always trained, always exchanged.

In the port a parameter tree is a flat ``{path: tensor}`` dict whose paths
are the JAX key paths joined with ``/`` (``"enc/blocks/attn/wq"``,
``"proj/layers/0/bn/scale"``), kept in ``jax.tree_util`` leaf order.
"""
from __future__ import annotations

from typing import Tuple

STACKED_KEYS = ("blocks", "moe_blocks", "mlstm", "slstm", "enc_blocks",
                "dec_blocks")
EMBED_KEYS = ("embed", "patch", "pos", "cls", "lm_head")
HEAD_KEYS = ("proj", "pred")

KINDS = ("stacked", "embed", "head", "extra")


def path_keys(path) -> Tuple[str, ...]:
    """Key-path entries of a ``/``-joined path (or a tuple of entries)."""
    if isinstance(path, str):
        return tuple(path.split("/"))
    return tuple(str(p) for p in path)


def classify_leaf(path) -> str:
    """Map a leaf's key path to one of ``KINDS``."""
    keys = path_keys(path)
    if any(k in STACKED_KEYS for k in keys):
        return "stacked"
    if any(k in EMBED_KEYS for k in keys):
        return "embed"
    if any(k in HEAD_KEYS for k in keys):
        return "head"
    return "extra"


def tree_order_key(path: str):
    """Sort key that puts ``/``-joined paths in ``jax.tree_util`` order:
    dict keys sorted as strings, list indices as integers."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in path.split("/"))


def tree_sorted(flat: dict) -> dict:
    """``flat`` re-keyed in ``jax.tree_util`` leaf order."""
    return {k: flat[k] for k in sorted(flat, key=tree_order_key)}
