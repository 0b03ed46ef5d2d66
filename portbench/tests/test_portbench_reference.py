"""The plain reference agrees with the port's plain branches (the einsum
cfconv; the unfused triplet chain) at a tiny size on the CPU: the loss of
the cell and its gradient for every leaf, from the same weights on the
same molecules. Float32 sums in another order: the loss to 1e-5, each
leaf's gradient to 1e-3 of its norm (the force loss's second derivatives
amplify rounding)."""
import pytest
import torch

from portbench.core import spec, traffic, weights
from portbench.reference import common
from portbench.tests._tiny import shrink

CPU = torch.device("cpu")


def _setup(cell, seed=3):
    w = spec.cell(cell)
    cfg = spec.config(w["config"])
    t = shrink(spec.traffic(w["traffic"]), 2)
    ref = spec.module("reference", w["config"])
    groups = traffic.groups(t, seed)
    w0 = weights.draw(ref.param_spec(cfg), seed, CPU)
    pool = spec.module("models", w["config"]).pool(cfg, t, groups, CPU)
    return cfg, t, ref, groups[0], w0, pool[0]


def _compare(loss, model, ref_loss, ref_grads):
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    for k, g in zip(names, grads):
        r = ref_grads[k]
        assert float((g - r).norm()) <= 1e-3 * float(r.norm()) + 1e-12, k


def test_schnet_dense_reference():
    from dig_tpu_torch.models import SchNetDense
    from dig_tpu_torch.train.trainer import dense_loss

    cell = "schnet_dense_qm9.energy_b3472"
    cfg, t, ref, mols, w0, batch = _setup(cell)
    model = SchNetDense(cutoff=cfg["cutoff"], num_layers=cfg["num_layers"],
                        hidden_channels=cfg["hidden_channels"],
                        num_filters=cfg["num_filters"],
                        num_gaussians=cfg["num_gaussians"], device=CPU)
    weights.load_into(model, w0)
    loss, grads = ref.loss_and_grads(dict(w0), mols, cfg, t,
                                     common.Precision())
    _compare(dense_loss(model, batch), model, loss, grads)


@pytest.mark.parametrize("cell", ["spherenet_qm9.energy_b384",
                                  "spherenet_qm9.force_b384"])
def test_spherenet_reference(cell):
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train.trainer import bucketed_force_loss

    from portbench.models.spherenet_qm9 import MODEL_KEYS
    cfg, t, ref, mols, w0, batch = _setup(cell)
    model = SphereNet(**{k: cfg[k] for k in MODEL_KEYS}, block_size=29,
                      device=CPU)
    weights.load_into(model, w0)
    loss, grads = ref.loss_and_grads(dict(w0), mols, cfg, t,
                                     common.Precision())
    if t["kind"] == "energy_force":
        ours = bucketed_force_loss(model, batch, t["loss"]["force_weight"])
    else:
        e = model(batch, block_size=29)
        ours = torch.mean(torch.abs(e - batch.globals["energy"]))
    _compare(ours, model, loss, grads)


def test_tf32_round():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10])
    assert common.tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9,
                                             -1.0 - 2 ** -10]
