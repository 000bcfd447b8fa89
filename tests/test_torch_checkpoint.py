"""Checkpoint parity: ``repro_torch.checkpoint`` against ``repro.checkpoint``.

A checkpoint written by either package loads into the other bit for bit:
a real small SSL state (the reference's ``ssl_init`` of a 2-block ViT with
its MoCo v3 heads) and an LM params dict (the reduced zamba2 of
``tests/test_torch_fl_lm.py``), and the ``fl_state`` directory layout.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.models import lm as jlm
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.launch.train import LM_ARCHS


def _ssl_state():
    cfg = jbase.ModelConfig("t-vit", "dense", 2, 32, 2, 2, 64, 0,
                            causal=False, compute_dtype="float32",
                            act="gelu")
    return jssl.ssl_init(jax.random.PRNGKey(1), jssl.make_vit_encoder(cfg),
                         jbase.SSLConfig(proj_hidden=32, pred_hidden=32,
                                         proj_dim=16))


def _lm_params():
    cfg = jbase.reduced(jbase.load_arch("zamba2-2.7b"),
                        **LM_ARCHS["zamba2-2.7b"])
    return jlm.init_lm(jax.random.PRNGKey(2), cfg)


def _port_tree(jtree):
    """The port's form of a reference tree: the SSL state's dict of flat
    dicts, or one flat dict."""
    host = jax.device_get(jtree)
    if set(host) == {"online", "target"}:
        return convert.state_from_numpy(host)
    return convert.from_numpy_tree(host)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _assert_trees_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("make", [_ssl_state, _lm_params])
def test_reference_checkpoint_loads_into_port(make, tmp_path):
    jtree = make()
    jckpt.save_pytree(tmp_path / "ref.npz", jtree)
    want = _port_tree(jtree)
    got = tckpt.load_pytree(tmp_path / "ref.npz", _zeros_like(want))
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("make", [_ssl_state, _lm_params])
def test_port_checkpoint_loads_into_reference(make, tmp_path):
    jtree = make()
    tckpt.save_pytree(tmp_path / "port.npz", _port_tree(jtree))
    got = jckpt.load_pytree(tmp_path / "port.npz",
                            jax.tree.map(jnp.zeros_like, jtree))
    want_leaves = jax.tree_util.tree_leaves_with_path(jtree)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(p))
    # and the two files hold the same keys and bytes
    jckpt.save_pytree(tmp_path / "ref.npz", jtree)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_fl_state_round_trips_both_ways(tmp_path):
    jstate = _ssl_state()
    state = _port_tree(jstate)
    tckpt.save_fl_state(tmp_path / "port", state, 7, {"schedule": "e2e"})
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == {"round": 7, "schedule": "e2e"}
    got, rnd, meta = tckpt.load_fl_state(tmp_path / "port",
                                         _zeros_like(state))
    assert rnd == 7 and meta["schedule"] == "e2e"
    _assert_trees_equal(got, state)
    jgot, jrnd, _ = jckpt.load_fl_state(
        tmp_path / "port", jax.tree.map(jnp.zeros_like, jstate))
    assert jrnd == 7
    _assert_trees_equal(_port_tree(jgot), state)
    jckpt.save_fl_state(tmp_path / "ref", jstate, 3)
    got, rnd, _ = tckpt.load_fl_state(tmp_path / "ref", _zeros_like(state))
    assert rnd == 3
    _assert_trees_equal(got, state)


def test_load_casts_to_like_and_checks_shapes(tmp_path):
    tree = {"enc/w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "proj/layers/0/b": torch.ones(4, dtype=torch.float64)}
    tckpt.save_pytree(tmp_path / "t.npz", tree)
    like = {"enc/w": torch.zeros(2, 3, dtype=torch.float64),
            "proj/layers/0/b": torch.zeros(4, dtype=torch.float32)}
    got = tckpt.load_pytree(tmp_path / "t.npz", like)
    assert got["enc/w"].dtype == torch.float64
    assert got["proj/layers/0/b"].dtype == torch.float32
    assert torch.equal(got["enc/w"], tree["enc/w"].double())
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(tmp_path / "t.npz",
                          {**like, "enc/w": torch.zeros(3, 2)})


def test_bfloat16_leaf_is_refused(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.save_pytree(tmp_path / "bf.npz",
                          {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert not (tmp_path / "bf.npz").exists()
