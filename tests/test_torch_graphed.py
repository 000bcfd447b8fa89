"""Server calibration's CUDA-graph path (``server._CalibrationGraph``) on
the CPU, with a stand-in for the graph: ``GraphedStep`` replaced by one
whose capture runs nothing and whose replay runs the captured Python step
again, which is what a replay of a CUDA graph computes. The graphed
calibration then has to give the eager loop's state to the bit, step for
step: the static buffers, the copies back into them, the per-step
scalars filled before each replay and the mask built once are all that
differ. The card's own test (``test_torch_cuda.py``) runs the real
graph."""
import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.configs.base import SSLConfig, TrainConfig, load_arch, \
    reduced
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.augment import two_views
from repro_torch.data.synthetic import synthetic_images
from repro_torch.federated import server
from repro_torch.federated.client import train_step
from repro_torch.federated.draws import TorchDraws
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)


class _ReplayedInPython:
    """``GraphedStep``'s surface; a replay reruns ``step``."""
    made = []

    @staticmethod
    def available(device):
        return True

    def __init__(self, step, device):
        self.step, self.replays, self.closed = step, 0, False
        _ReplayedInPython.made.append(self)

    def replay(self):
        self.step()
        self.replays += 1

    def close(self):
        self.closed = True


CASES = [("moco_v3", "adamw"), ("byol", "adafactor"), ("simclr", "sgdm")]


@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("method,optimizer", CASES)
def test_graph_path_gives_the_eager_loops_bits(monkeypatch, method,
                                               optimizer, epochs):
    cfg = reduced(load_arch("vit-tiny"), num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64)
    ssl_cfg = SSLConfig(method=method, proj_hidden=32, pred_hidden=32,
                        proj_dim=16)
    encoder = ssl_mod.make_vit_encoder(cfg)
    opt = make_optimizer(TrainConfig(batch_size=8, optimizer=optimizer,
                                     weight_decay=0.1))
    images, _ = synthetic_images(torch.Generator().manual_seed(0), 16, 10,
                                 32)
    state = TorchDraws(0, "cpu").init_state(encoder, ssl_cfg)
    lr, steps = 1e-3, 2 * epochs

    draws = TorchDraws(1, "cpu")
    want, opt_state = state, opt.init(state["online"])
    for idx, handle in draws.batch_plan(16, epochs, 8, calibration=True):
        x1, x2 = two_views(images[idx], *draws.views(handle, 8, 32, 32))
        want, opt_state, _ = train_step(
            want, opt_state, x1, x2, lr, encoder=encoder, ssl_cfg=ssl_cfg,
            opt=opt, sub_layers=cfg.num_layers, active_from=0)

    monkeypatch.setattr(server, "GraphedStep", _ReplayedInPython)
    _ReplayedInPython.made = []
    obs = tobs.make_obs(trace=True)
    got = server.server_calibrate(
        state, images, TorchDraws(1, "cpu"), opt, encoder=encoder,
        ssl_cfg=ssl_cfg, sub_layers=cfg.num_layers, epochs=epochs,
        batch_size=8, lr=lr, tracer=obs.tracer)
    assert set(got) == set(want)
    for br in want:
        for k in want[br]:
            assert torch.equal(got[br][k], want[br][k]), (br, k)
    # the input state is read, never written
    fresh = TorchDraws(0, "cpu").init_state(encoder, ssl_cfg)
    for br in state:
        for k in state[br]:
            assert torch.equal(state[br][k], fresh[br][k]), (br, k)
    (graph,) = _ReplayedInPython.made
    assert graph.closed and graph.replays == steps - 1
    modes = [e["args"]["mode"] for e in obs.tracer.events
             if e["name"] == "calibrate.step"]
    assert modes == ["eager", "capture"] + ["replay"] * (steps - 2)
    (cal,) = [e for e in obs.tracer.events if e["name"] == "calibrate"]
    assert cal["args"]["replays"] == steps - 1


def test_one_step_calibration_makes_no_graph(monkeypatch):
    """A calibration of a single step runs it eagerly and captures
    nothing; the ``calibrate`` span then carries no replay count."""
    cfg = reduced(load_arch("vit-tiny"), num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64)
    ssl_cfg = SSLConfig(proj_hidden=32, pred_hidden=32, proj_dim=16)
    encoder = ssl_mod.make_vit_encoder(cfg)
    opt = make_optimizer(TrainConfig(batch_size=8))
    images, _ = synthetic_images(torch.Generator().manual_seed(0), 8, 10,
                                 32)
    state = TorchDraws(0, "cpu").init_state(encoder, ssl_cfg)
    monkeypatch.setattr(server, "GraphedStep", _ReplayedInPython)
    _ReplayedInPython.made = []
    obs = tobs.make_obs(trace=True)
    server.server_calibrate(state, images, TorchDraws(1, "cpu"), opt,
                            encoder=encoder, ssl_cfg=ssl_cfg, sub_layers=1,
                            epochs=1, batch_size=8, lr=1e-3,
                            tracer=obs.tracer)
    assert _ReplayedInPython.made == []
    (cal,) = [e for e in obs.tracer.events if e["name"] == "calibrate"]
    assert "replays" not in cal["args"]
    assert [e["args"]["mode"] for e in obs.tracer.events
            if e["name"] == "calibrate.step"] == ["eager"]
