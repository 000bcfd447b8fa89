"""Linear evaluation (paper Section 5.1; ``repro.federated.eval``): the
heads are dropped and a linear classifier is trained on the frozen
encoder's representations."""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.convert import to_tensor
from repro_torch.models.layers.init import dense_init_
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import learning_rate


@torch.no_grad()
def extract_features(encoder, enc_params, images: torch.Tensor,
                     batch_size: int = 256) -> torch.Tensor:
    """Features of whole batches; a pool smaller than one batch is taken
    as one partial batch (the reference's own loop, ``eval.py:20-26``)."""
    feats = []
    n = (images.shape[0] // batch_size) * batch_size
    for i in range(0, max(n, batch_size), batch_size):
        xb = images[i:i + batch_size]
        if xb.shape[0] == 0:
            break
        feats.append(encoder.apply(enc_params, xb))
    return torch.cat(feats, dim=0)


def linear_eval(encoder, enc_params, train_images, train_labels,
                test_images, test_labels, *, num_classes: int,
                epochs: int = 20, batch_size: int = 256, lr: float = 3e-2,
                train_cfg=None, generator=None) -> float:
    """Test accuracy of a linear probe trained on frozen features. Runs on
    the device of ``enc_params``."""
    device = next(iter(enc_params.values())).device
    generator = (generator if generator is not None
                 else torch.Generator(device).manual_seed(0))
    f_train = extract_features(encoder, enc_params,
                               to_tensor(train_images, device), batch_size)
    f_test = extract_features(encoder, enc_params,
                              to_tensor(test_images, device), batch_size)
    y_train = to_tensor(train_labels, device, torch.int64)[:f_train.shape[0]]
    y_test = to_tensor(test_labels, device, torch.int64)[:f_test.shape[0]]
    d = f_train.shape[-1]
    tc = train_cfg or TrainConfig(optimizer="adamw", base_lr=lr,
                                  weight_decay=1e-5)
    opt = make_optimizer(tc)
    w = torch.empty((d, num_classes), dtype=torch.float32, device=device)
    params = {"b": torch.zeros(num_classes, device=device),
              "w": dense_init_(w, d, generator)}
    opt_state = opt.init(params)
    steps_per_epoch = f_train.shape[0] // batch_size
    total_steps = epochs * max(1, steps_per_epoch)
    t = 0
    for _ in range(epochs):
        perm = torch.randperm(f_train.shape[0], generator=generator,
                              device=device)
        for b in range(steps_per_epoch):
            sel = perm[b * batch_size:(b + 1) * batch_size]
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            logits = f_train[sel] @ p["w"] + p["b"]
            loss = torch.nn.functional.cross_entropy(logits, y_train[sel])
            grads = torch.autograd.grad(loss, list(p.values()))
            params, opt_state = opt.update(
                dict(zip(p, grads)), opt_state, params,
                learning_rate(t, total_steps, lr, "cosine"))
            t += 1
    logits = f_test @ params["w"] + params["b"]
    return float((logits.argmax(-1) == y_test).float().mean())
