"""Round-resumable FL training state (``repro.checkpoint.fl_state``): the
global model as ``global_state.npz`` and the round counter in
``meta.json``, the reference's layout."""
from __future__ import annotations

import json
import pathlib

from repro_torch.checkpoint.npz import load_pytree, save_pytree


def save_fl_state(dirpath, state, round_idx: int, meta: dict | None = None):
    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    save_pytree(d / "global_state.npz", state)
    (d / "meta.json").write_text(json.dumps(
        {"round": round_idx, **(meta or {})}))


def load_fl_state(dirpath, like):
    """(state restored into ``like``'s structure, dtypes and devices,
    round, meta)."""
    d = pathlib.Path(dirpath)
    meta = json.loads((d / "meta.json").read_text())
    state = load_pytree(d / "global_state.npz", like)
    return state, meta["round"], meta
