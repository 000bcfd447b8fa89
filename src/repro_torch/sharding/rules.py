"""Logical-axis sharding rules -> per-dim specs and DTensor placements
(``repro.sharding.rules``, MaxText-style).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.
  fsdp = ("pod", "data")   parameter / batch sharding (ZeRO-3 style)
  tp   = ("model",)        tensor / expert parallel

Every rule is a tuple of tokens for a leaf's *trailing* dims (leading
stage-stack dims are replicated): "fsdp" / "tp" / "all" / None. A token
degrades gracefully: an axis group is used only when the dim divides
evenly by it, otherwise its suffixes (the biggest axes dropped first),
otherwise replication. One table thus holds for every architecture (kv-head
dims smaller than the model axis simply stay replicated).

Weight matrices follow Megatron: column-parallel for d_model -> wide
projections ("fsdp", "tp"), row-parallel for wide -> d_model ("tp",
"fsdp"); MoE expert stacks are expert-parallel on "model" with FSDP on
d_model; KV caches shard the batch over fsdp and the sequence over
"model" (context-parallel decode; for a global batch of 1 the sequence
shards over *all* axes).

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
names, or None; it is the reference's ``PartitionSpec``, entry for entry
(a replicated unknown leaf is the empty ``()``, as ``P()``). Leaves are
addressed by the port's tree keys, the reference's key paths joined with
"/" (``convert.py``). A mesh is anything with ``axis_names`` and a
``shape`` dict (``launch.mesh.MeshShape``, the reference's duck meshes)
or a ``DeviceMesh``. ``to_placements`` turns a spec into DTensor
placements on a ``DeviceMesh``; ``local_shape`` is one device's shard.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.launch.mesh import MeshShape

Spec = Tuple


def _mesh(mesh):
    return MeshShape.of(mesh) if hasattr(mesh, "mesh_dim_names") else mesh


def _prod(sizes) -> int:
    n = 1
    for s in sizes:
        n *= int(s)
    return n


def _axes(mesh):
    names = mesh.axis_names
    fsdp = tuple(n for n in ("pod", "data") if n in names)
    return fsdp, ("model",) if "model" in names else ()


def _resolve(token, dim_size, mesh, used=()):
    """Token -> mesh-axis entry for one dim, honouring divisibility and
    skipping axes already used elsewhere in the same spec."""
    if token is None:
        return None
    fsdp, tp = _axes(mesh)
    groups = {"fsdp": fsdp, "tp": tp, "all": fsdp + tp}[token]
    groups = tuple(a for a in groups if a not in used)
    # the full group, then its suffixes (the biggest axes dropped first)
    for i in range(len(groups)):
        sub = groups[i:]
        prod = _prod(mesh.shape[a] for a in sub)
        if prod > 1 and dim_size % prod == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def _spec_from_rule(rule, shape, mesh) -> Spec:
    n_lead = len(shape) - len(rule)
    return tuple([None] * n_lead + [
        _resolve(tok, shape[n_lead + i], mesh) for i, tok in enumerate(rule)])


# rules keyed by leaf name (trailing-dims tokens)
PARAM_RULES = {
    # attention projections
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # MLP (dense & shared experts & mLSTM up/down)
    "w_up": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    # embeddings / output head
    "embed": ("tp", "fsdp"), "lm_head": ("fsdp", "tp"),
    # mamba2
    "w_in": ("fsdp", "tp"), "w_out": ("tp", "fsdp"),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "a_log": (None,), "dt_bias": (None,), "D": (None,),
    # MLA
    "w_dkv": ("fsdp", None), "w_kr": ("fsdp", None),
    "w_dq": ("fsdp", None), "w_uq": (None, "tp"),
    "w_uk": ("tp", None, None), "w_uv": ("tp", None, None),
    "w_q": ("fsdp", "tp"),
    # xLSTM (w_q shared with MLA; w_k/w_v are the (di, di) projections)
    "w_k": ("fsdp", "tp"), "w_v": ("fsdp", "tp"),
    "r": (None, "fsdp", "tp"), "w_i": ("fsdp", None), "w_f": ("fsdp", None),
    "b_i": (None,), "b_f": (None,), "w": ("fsdp", "tp"), "b": (None,),
    # MoE router
    "router": ("fsdp", None),
    # ViT stem
    "patch": (None, "fsdp"), "pos": (None, None), "cls": (None, None, None),
    # norms / biases
    "scale": (None,), "bias": (None,),
}

# expert-stacked MoE weights (under a "moe" parent, excluding "shared")
MOE_EXPERT_RULES = {
    "w_gate": ("tp", "fsdp", None),
    "w_up": ("tp", "fsdp", None),
    "w_down": ("tp", None, "fsdp"),
}


def _keys(path) -> Tuple[str, ...]:
    return tuple(path.split("/")) if isinstance(path, str) else \
        tuple(str(p) for p in path)


def param_pspec(path, leaf, mesh) -> Spec:
    mesh = _mesh(mesh)
    keys = _keys(path)
    name = keys[-1]
    if "moe" in keys and "shared" not in keys and name in MOE_EXPERT_RULES:
        rule = MOE_EXPERT_RULES[name]
    elif name in PARAM_RULES:
        rule = PARAM_RULES[name]
    else:
        return ()           # replicate unknown leaves
    if len(rule) > len(leaf.shape):
        return ()
    return _spec_from_rule(rule, tuple(leaf.shape), mesh)


def param_pspecs(params: Dict, mesh) -> Dict[str, Spec]:
    """``{path: leaf}`` (tensors, or anything with a ``shape``) -> ``{path:
    spec}``."""
    return {k: param_pspec(k, v, mesh) for k, v in params.items()}


# ---------------------------------------------------------------------------
# optimizer state: moments shard like their parameters
# ---------------------------------------------------------------------------
def opt_state_specs(opt_state, param_specs: Dict[str, Spec], optimizer: str,
                    mesh) -> dict:
    """Specs of a state of ``optim.make_optimizer`` (the same dict layout,
    a spec for each tensor and for the step count ``()``). AdamW's mu and
    nu and SGDM's v shard like their parameters; Adafactor's factored row
    and column moments take the parameter's spec without its last, or its
    second to last, dim."""
    if optimizer in ("adamw", "sgdm"):
        out = {}
        for k, v in opt_state.items():
            if k == "count":
                out[k] = ()
            elif k in ("mu", "nu", "v"):
                out[k] = {p: param_specs[p] for p in v}
            else:
                out[k] = {p: () for p in v}
        return out
    if optimizer == "adafactor":
        def leaf(spec, st):
            if "vr" in st:
                ent = list(spec) + [None] * (len(st["vr"].shape) + 1
                                             - len(spec))
                return {"vr": tuple(ent[:-1]),
                        "vc": tuple(ent[:-2] + [ent[-1]])}
            return {"v": spec}
        return {"m": {p: leaf(param_specs[p], st)
                      for p, st in opt_state["m"].items()},
                "count": ()}
    raise ValueError(optimizer)


# ---------------------------------------------------------------------------
# serving caches / recurrent states
# ---------------------------------------------------------------------------
CACHE_BATCH_POS = {   # name -> batch dim position from the END of the shape
    "k": 4, "v": 4,                 # (..., B, W, Hkv, hd)
    "c_kv": 3, "k_rope": 3,         # (..., B, W, rank)
    "h": 4,                         # (..., B, H, P, N)
    "conv": 3,                      # (..., B, K-1, C)
    "C": 4,                         # (..., B, H, P, P)   mLSTM matrix memory
    "n": 3,                         # (..., B, H, P)
    "m": 2,                         # (..., B, H)
    "c": 2,                         # (..., B, d)         sLSTM
}
# per-name rule for the dims after the batch dim
CACHE_TAIL_RULES = {
    "k": ("seq", "tp", None), "v": ("seq", "tp", None),
    "c_kv": ("seq", None), "k_rope": ("seq", None),
    "h": ("tp", None, None), "conv": (None, "tp"),
    "C": (None, "tp", None), "n": (None, "tp"), "m": (None,),
    "c": ("tp",),
}


def cache_pspec(path, leaf, mesh, batch: int) -> Spec:
    mesh = _mesh(mesh)
    keys = _keys(path)
    name = keys[-1]
    shape = tuple(leaf.shape)
    if name == "pos":
        return ()
    if "slstm" in keys:
        # sLSTM state leaves are all (..., B, d) regardless of name
        bpos, tail = len(shape) - 2, ("tp",)
    elif name in CACHE_BATCH_POS:
        bpos = len(shape) - CACHE_BATCH_POS[name]
        tail = CACHE_TAIL_RULES[name]
    else:
        return ()
    fsdp, _ = _axes(mesh)
    fsdp_size = _prod(mesh.shape[a] for a in fsdp) if fsdp else 1
    batch_shardable = fsdp_size > 1 and batch % fsdp_size == 0
    entries = [None] * len(shape)
    used = set()

    def mark(entry):
        if entry is not None:
            used.update(entry if isinstance(entry, tuple) else (entry,))
        return entry

    if batch_shardable:
        entries[bpos] = mark(fsdp if len(fsdp) > 1 else fsdp[0])
    for i, tok in enumerate(tail):
        dim = bpos + 1 + i
        if dim >= len(shape) or tok is None:
            continue
        if tok == "seq":
            # context parallel: over "model"; over everything when the
            # batch could not be sharded (global_batch=1 long decode)
            tok = "tp" if batch_shardable else "all"
        entries[dim] = mark(_resolve(tok, shape[dim], mesh,
                                     used=tuple(used)))
    return tuple(entries)


def cache_pspecs(caches: Dict, mesh, batch: int) -> Dict[str, Spec]:
    return {k: cache_pspec(k, v, mesh, batch) for k, v in caches.items()}


# ---------------------------------------------------------------------------
# batch inputs
# ---------------------------------------------------------------------------
def batch_spec(leaf, mesh) -> Spec:
    """Dim 0 (the global batch) over the fsdp axes when divisible."""
    shape = tuple(leaf.shape)
    if not shape:
        return ()
    return (_resolve("fsdp", shape[0], _mesh(mesh)),) + \
        (None,) * (len(shape) - 1)


def batch_specs(batch: Dict, mesh) -> Dict[str, Spec]:
    return {k: batch_spec(v, mesh) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: Spec, mesh) -> list:
    """A spec as DTensor placements on the ``DeviceMesh`` ``mesh``: each
    mesh dim ``Shard(d)`` of the tensor dim d whose entry names it, else
    ``Replicate()``. A dim over several axes, ("pod", "data"), is
    ``Shard(d)`` on each of those mesh dims. DTensor splits such a dim over
    its mesh dims in mesh order, the first mesh dim outermost, so the
    device at (pod p, data q) holds chunk p * |data| + q: the reference's
    layout, whose entries list their axes in mesh order (``_resolve``
    takes them from the ordered groups). An entry out of mesh order, or an
    axis named twice, has no such placement and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or seen & set(idx):
            raise ValueError(f"spec {spec}: entry {entry} is out of mesh "
                             f"order {names} or reuses an axis")
        seen.update(idx)
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` (the first device's, the largest where a dim does not divide,
    as DTensor chunks it)."""
    sizes = _mesh(mesh).shape
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = _prod(sizes[a] for a in axes)
        out[dim] = -(-out[dim] // n)
    return tuple(out)
