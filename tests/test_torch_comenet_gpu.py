"""One ComENet step (energy+force, NK-blocked and periodic) and one ProNet
step (energy, NK-blocked) at small widths on the card against the same
step on the CPU, where every op takes its plain version: the same seeded
weights and batch, the loss within 1e-4 and every parameter's gradient
within 1e-3 (||card - CPU|| / ||CPU||, float32, TF32 off); the card's
segment sums went through the sorted-CSR kernel.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test). Run on a machine with the card, without the JAX
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_comenet_gpu.py
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

CE = dict(cutoff=6.0, num_layers=2, hidden_channels=64, middle_channels=32,
          num_radial=3, num_spherical=2, num_output_layers=2)
PN = dict(level="allatom", num_blocks=2, hidden_channels=64, mid_emb=32,
          cutoff=10.0, num_radial=3, num_spherical=2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _step(make_model, batch, force):
    from dig_tpu_torch.train import make_step_fns
    model = make_model(batch.node_mask.device)
    step = make_step_fns(model, torch.optim.SGD(model.parameters(), lr=0.0),
                         energy_and_force=force, p=100.0, loss="l1")[0]
    loss = step(batch)["loss"]
    return float(loss), [p.grad.detach().cpu() for p in model.parameters()]


def _check(make_model, loader, force):
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _card()
    sc.reset_launch_counts()
    lk, gk = _step(make_model, next(iter(loader(dev))), force)
    assert sc.launches > 0
    lp, gp = _step(make_model, next(iter(loader("cpu"))), force)
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert _rel(a, b) < 1e-3


@pytest.mark.parametrize("layout", ["nk_blocked", "periodic"])
def test_comenet_step_matches_cpu(layout):
    from dig_tpu_torch.datasets import (MoleculeLoader, morse_energy,
                                        synthetic_crystals,
                                        synthetic_molecules)
    from dig_tpu_torch.models import ComENet, ComENetOCP
    if layout == "periodic":
        data = [dict(c, force=morse_energy(c["z"], c["pos"])[1])
                for c in synthetic_crystals(4, seed=1, min_atoms=10,
                                            max_atoms=30)]
        kw, M, lkw = dict(max_edges=16384), ComENetOCP, dict(n_node_pad=120)
    else:
        data = [dict(m, y=m["y"][:1]) for m in synthetic_molecules(
            8, seed=1, min_atoms=12, max_atoms=29, box=6.0, with_forces=True)]
        kw, M = dict(nk_degree=28, block_size=29), ComENet
        lkw = dict(slot_size=29)
    _check(lambda d: M(**CE, **kw, generator=torch.Generator().manual_seed(0),
                       device=d),
           lambda d: MoleculeLoader(data, len(data), device=d, **lkw), True)


def test_pronet_step_matches_cpu():
    from dig_tpu_torch.datasets import ProteinLoader, synthetic_proteins
    from dig_tpu_torch.models import ProNet
    prots = synthetic_proteins(4, min_res=30, max_res=64, seed=1)
    _check(lambda d: ProNet(**PN, nk_degree=32, block_size=64,
                            generator=torch.Generator().manual_seed(0),
                            device=d),
           lambda d: ProteinLoader(prots, 4, slot_size=64, device=d), False)
