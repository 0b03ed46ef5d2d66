"""How well the float32 loss of a DimeNet++ energy+force step is
conditioned at the published basis (n = 7, k = 6), on the CPU.

    python scripts/force_conditioning.py [molecules]

One step at lr 0 of DimeNet++ (its defaults, the unblocked K = 16 table,
p = 100) on a MoleculeLoader batch of synthetic molecules (12-29 atoms,
6 A box, seeded forces), in float32 with the plain PyTorch versions: the
unfused branch with 1 and with 4 CPU threads (the same function, only the
order of the matmul sums differs), and the triplet-product and
packed-basis branches. Prints each branch's energy and force terms, their
relative gaps to the unfused branch at 4 threads, the worst parameter
gradient's relative gap, and the smallest k-j distance over the cutoff
(where the spherical Bessel closed forms up to l = 6 cancel).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main():
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import DimeNetPP
    from dig_tpu_torch.train import make_step_fns

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    mols = synthetic_molecules(n, seed=0, min_atoms=12, max_atoms=29,
                               box=6.0, with_forces=True)
    g = next(iter(MoleculeLoader([dict(m, y=m["y"][:1]) for m in mols], n,
                                 device="cpu")))

    def step(threads, **flags):
        torch.set_num_threads(threads)
        m = DimeNetPP(nk_degree=16, block_size=0, device="cpu",
                      generator=torch.Generator().manual_seed(0), **flags)
        aux = make_step_fns(m, torch.optim.SGD(m.parameters(), lr=0.0),
                            energy_and_force=True, p=100.0, loss="l1")[0](g)
        return ({k: float(v) for k, v in aux.items()},
                [p.grad.clone() for p in m.parameters()], m)

    base, g0, model = step(4)
    geo = model.geometry(g.nodes["pos"], g)
    x = geo.dist_kj[geo.trip.mask] / model.cutoff
    print(f"{n} molecules; smallest d_kj / cutoff {float(x.min()):.4f}")
    print(f"unfused, 4 threads: energy term {base['e_loss']:.7f}, force term "
          f"{base['f_loss']:.7f}")
    for name, threads, flags in (
            ("unfused, 1 thread", 1, {}),
            ("triplet product", 4, dict(pallas_triplet=True)),
            ("packed basis", 4, dict(pallas_triplet=True,
                                     pallas_fuse_basis=True))):
        aux, grads, _ = step(threads, **flags)
        rel = {k: abs(aux[k] - base[k]) / abs(base[k])
               for k in ("e_loss", "f_loss")}
        worst = max(float((a - b).norm() / b.norm()) for a, b in zip(grads, g0))
        print(f"{name}: energy term rel gap {rel['e_loss']:.3e}, force term "
              f"rel gap {rel['f_loss']:.3e}, worst parameter gradient "
              f"{worst:.3e}")


if __name__ == "__main__":
    main()
