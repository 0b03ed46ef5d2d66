"""Train steps repeat bit for bit on the card: one energy+force step from
the same seeded state, taken in two fresh processes, gives the same loss
and the same parameters after Adam, on the flat layout (SchNet: row
gathers, the edge->node sum and the readout through the sorted-CSR
kernel), the slot layout and the unblocked packed-basis layout (SphereNet
through the slot and the ``triplet_pt`` kernels, the readout and the atom
embedding's gather through the sorted-CSR kernel). Each step runs in a
process of its own: within one process a second force step need not
repeat the first, because the autograd engine orders the outer backward
by sequence numbers that the double backward's nodes draw from the
device thread's counter, which runs on across steps.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test). Run on a machine with the card, without the JAX
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_repeat_gpu.py
"""
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

A = 29
SN = dict(cutoff=5.0, num_layers=2, hidden_channels=64, int_emb_size=32,
          out_emb_channels=64, num_spherical=3, num_radial=6, nk_degree=16,
          pallas_triplet=True, pallas_fuse_basis=True)
LAYOUTS = {
    "schnet_flat": (dict(cutoff=5.0, num_layers=2, hidden_channels=64,
                         num_filters=64, num_gaussians=50, max_edges=16384,
                         segment_eb=1024), None),
    "spherenet_slot": (dict(SN, block_size=A, pallas_slot=True), A),
    "spherenet_pt": (dict(SN, block_size=0), None),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_step(layout, out):
    """One energy+force Adam step of the layout's model from the seeded
    state on a batch of 16 seeded molecules; loss and parameters to
    ``out``."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SchNet, SphereNet
    from dig_tpu_torch.train import make_step_fns
    dev = torch.device("cuda")
    kw, slot = LAYOUTS[layout]
    mols = synthetic_molecules(16, seed=0, min_atoms=12, max_atoms=A,
                               box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    batch = next(iter(MoleculeLoader(mols, 16, slot_size=slot, device=dev)))
    M = SchNet if layout == "schnet_flat" else SphereNet
    model = M(**kw, generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, energy_and_force=True, p=100.0,
                            loss="l1")
    loss = step(batch)["loss"]
    torch.save({"loss": loss.detach().cpu(),
                **{n: p.detach().cpu() for n, p in model.named_parameters()}},
               out)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_identical_force_steps_give_the_same_bits(layout, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = []
    for i in range(2):
        out = str(tmp_path / f"{i}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), layout,
                        out], check=True, env=env, timeout=600)
        runs.append(torch.load(out))
    a, b = runs
    assert torch.isfinite(a["loss"])
    assert all(torch.equal(a[k], b[k]) for k in a)


if __name__ == "__main__":
    one_step(*sys.argv[1:3])
