"""Graphair on the card: its first warm, adversary and main steps (dense
products: no kernel of the port's) against the same steps on the CPU from
the same weights and host-drawn uniforms, and fit_whole / test end to
end.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test). Run on a machine with the card, without the JAX
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_fairgraph_gpu.py

Tolerances: float32 with TF32 off, losses 1e-4 relative and gradients
1e-3 (||a-b|| / ||b|| per parameter): matrix products summed in another
order, and an edge sample thresholded at 0.5 may flip where the two
differ by a rounding.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _steps(data, d, noise):
    from dig_tpu_torch.fairgraph import Graphair
    m = Graphair(data["x"].shape[1], device=d)
    m.init(0)
    m.prepare(data["adj"], data["x"], data["sens"], data["idx_sens_train"])
    out = []
    for kind, parts, nz in (("warm", "aug", noise[0]), ("adv", "adv",
                                                        noise[1]),
                            ("main", "aug enc proj", noise[2])):
        loss = getattr(m, f"{kind}_step")(tuple(u.to(d) for u in nz))
        loss = loss[0] if isinstance(loss, tuple) else loss
        out.append((float(loss), [q.grad.detach().cpu()
                                  for p in parts.split()
                                  for q in getattr(m, p).parameters()]))
    return out


def test_graphair_first_steps_match_cpu():
    from dig_tpu_torch.fairgraph import Graphair, synthetic_fair_graph
    dev = _device()
    data = synthetic_fair_graph(512, avg_deg=16, seed=0)
    gen = torch.Generator().manual_seed(0)
    noise = [Graphair.draw(gen, 512, data["x"].shape[1]) for _ in range(3)]
    for (lk, gk), (lp, gp) in zip(_steps(data, dev, noise),
                                  _steps(data, torch.device("cpu"), noise)):
        assert abs(lk - lp) < 1e-4 * abs(lp)
        for a, b in zip(gk, gp):
            assert float((a - b).norm() / b.norm().clamp(min=1e-12)) < 1e-3


def test_graphair_run_on_card():
    from dig_tpu_torch.fairgraph import run, synthetic_fair_graph
    _device()
    res = run(synthetic_fair_graph(512, seed=1), epochs=20, warmup=2,
              classifier_epochs=100)
    assert 0.0 <= res["accuracy"] <= 1.0
    assert all(np.isfinite(v) for v in res.values())
