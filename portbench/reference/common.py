"""What the plain references share: matrix products in a stated
precision, the activations, Adam, and the driver that follows a
training run's first steps.

Plain PyTorch; imports nothing of the port. Every matrix product of a
reference goes through :class:`Precision`: ``"f32"`` is float32 with
TF32 off; ``"tf32"`` rounds both operands of every product to TF32's
10-bit mantissa (round to nearest even) and sums in float32, as the
card's TF32 path does, on any device. ``"tf32"`` is the check's control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

LOG2 = math.log(2.0)
BETAS, EPS = (0.9, 0.999), 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 (8-bit exponent, 10-bit mantissa),
    round to nearest even, with an identity derivative."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Precision:
    """Matrix products of one precision: ``linear`` and ``einsum``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision must be f32 or tf32, got {name!r}")
        self.name = name
        self._r = tf32_round if name == "tf32" else (lambda t: t)

    def linear(self, x, w, b=None):
        return F.linear(self._r(x), self._r(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._r(a), self._r(b))


def shifted_softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device)) - LOG2


def swish(x):
    return F.silu(x)


def lecun(fan_in: int):
    return ("normal", 1.0 / math.sqrt(fan_in))


def linear_spec(name: str, i: int, o: int, bias: bool):
    out = [(f"{name}.weight", (o, i), lecun(i))]
    if bias:
        out.append((f"{name}.bias", (o,), ("zeros",)))
    return out


def set_fp32_flags() -> None:
    """float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def follow(loss_and_grads: Callable, weights: Dict[str, torch.Tensor],
           batches: List[list], lr: float, prec: Precision,
           steps: int = 3) -> dict:
    """Run ``steps`` Adam steps (torch.optim.Adam's update, betas (0.9,
    0.999), eps 1e-8) from ``weights`` on ``batches[0..steps)``.
    ``loss_and_grads(params, molecules, prec) -> (loss, grads)``. Returns
    the step losses, the first step's gradient norm per leaf and the norm
    of each leaf's change after the last step."""
    set_fp32_flags()
    P = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, grad_norms = [], None
    for t in range(1, steps + 1):
        loss, grads = loss_and_grads(P, batches[t - 1], prec)
        losses.append(float(loss))
        if t == 1:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        with torch.no_grad():
            for k in P:
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = v2[k].sqrt() / math.sqrt(bc2) + EPS
                P[k].addcdiv_(m[k], denom, value=-lr / bc1)
    change = {k: float((P[k] - weights[k]).norm()) for k in P}
    return {"losses": losses, "grad": grad_norms, "change": change}


def chunks(items: list, size: int):
    for i in range(0, len(items), size):
        yield items[i:i + size]


def accumulate(total: Optional[dict], grads: dict) -> dict:
    if total is None:
        return {k: g.detach().clone() for k, g in grads.items()}
    for k, g in grads.items():
        total[k] += g.detach()
    return total
