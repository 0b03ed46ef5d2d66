"""The work of a SphereNet step on one batch: the model FLOPs from its
equations over real atoms, edges (the kept neighbour pairs) and real
triplets, and the calls of the port's slot kernels with their frozen
bounds.

Forward FLOPs (H hidden, I int_emb, O out_emb, k radial, n spherical,
Bd / Ba / Bt basis widths): per edge the init block (2kH + 2 * 3H * H +
2kH + H) and in each edge update lin_ji and lin_kj (4H^2), the radial
projection (2kBd + 2BdH + H), lin_down and lin_up (4HI), the skip and
the three residual layers (2H^2 + 3 * 4H^2) and lin_rbf_out (2kH + H);
per triplet in each edge update the factorised basis projections (2nk Ba
+ 2 Ba I + 2n^2k Bt + 2 Bt I) and the product and sum (3I); per node
update the edge sum (H an edge) and per atom lin_in (2HO), three Linears
(6O^2) and the output (2O). Energy training is 3 times the forward;
energy+force training 9 times (the forward, the force pass twice, the
outer backward of both twice again). Activations and bases are not
counted."""
from __future__ import annotations

from ..bounds import triplet_slot
from ..core.traffic import bucket_of
from ..reference.spherenet_qm9 import CHUNK, Graph, pad

KEYS = ("edges", "triplets", "x_rows", "tri_edges")


def work(cfg: dict, traffic: dict, mols, device) -> dict:
    """``{slot: {"G", "atoms", "edges", "triplets", "x_rows",
    "tri_edges"}}`` of one batch's molecules."""
    out = {int(s): dict(G=c, atoms=0, **{k: 0 for k in KEYS})
           for s, c in traffic["slots"].items()}
    for m in mols:
        out[bucket_of(len(m["z"]), traffic["slots"])]["atoms"] += len(m["z"])
    step = CHUNK["energy"]
    for i in range(0, len(mols), step):
        part = mols[i:i + step]
        _, pos, mask, _ = pad(part, device, False)
        per = Graph(pos, mask, cfg["cutoff"], cfg["nk_degree"]).counts(
            *mask.shape).tolist()
        for m, c in zip(part, per):
            b = out[bucket_of(len(m["z"]), traffic["slots"])]
            for key, v in zip(KEYS, c):
                b[key] += v
    return out


def step_flops(cfg: dict, traffic: dict, w: dict) -> float:
    H, I, O = (cfg["hidden_channels"], cfg["int_emb_size"],
               cfg["out_emb_channels"])
    n, k = cfg["num_spherical"], cfg["num_radial"]
    Bd, Ba, Bt = (cfg["basis_emb_size_dist"], cfg["basis_emb_size_angle"],
                  cfg["basis_emb_size_torsion"])
    L = cfg["num_layers"]
    atoms = sum(b["atoms"] for b in w.values())
    E = sum(b["edges"] for b in w.values())
    T = sum(b["triplets"] for b in w.values())
    res = cfg["num_before_skip"] + cfg["num_after_skip"]
    init = E * (4 * k * H + 6 * H * H + H)
    edge = (4 * H * H + 2 * k * Bd + 2 * Bd * H + H + 4 * H * I
            + 2 * H * H + res * 4 * H * H + 2 * k * H + 2 * H)
    trip = 2 * n * k * Ba + 2 * Ba * I + 2 * n * n * k * Bt + 2 * Bt * I \
        + 3 * I
    node = atoms * (2 * H * O + cfg["num_output_layers"] * 2 * O * O + 2 * O)
    fwd = init + L * (E * edge + T * trip) + (L + 1) * (E * H + node)
    return (9.0 if traffic["kind"] == "energy_force" else 3.0) * fwd


def kernel_calls(cfg: dict, traffic: dict, w: dict) -> dict:
    """``{family: (launches a step, bound ms a step)}`` of the slot
    kernels, float32, a layer and bucket: the forward and a backward
    without the basis cotangent; with forces also a backward with it
    (the force pass) and a second-order call (the outer backward of the
    force pass)."""
    n, k, K = cfg["num_spherical"], cfg["num_radial"], cfg["nk_degree"]
    C, L = cfg["int_emb_size"], cfg["num_layers"]
    nk, ntk = n * k, n * n * k
    R = nk + n + n * n
    force = traffic["kind"] == "energy_force"
    fb = b2 = 0.0
    for s, b in w.items():
        E = b["G"] * s * K
        args = (E, K, R, C, nk, ntk, b, 4, "f32")
        fb += triplet_slot.fwd_bwd_ms(*args, "fwd")
        fb += triplet_slot.fwd_bwd_ms(*args, "bwd", False)
        if force:
            fb += triplet_slot.fwd_bwd_ms(*args, "bwd", True)
            b2 += triplet_slot.bwd2_ms(*args)
    calls = L * len(w)
    out = {"triplet_slot": ((3 if force else 2) * calls, L * fb)}
    if force:
        out["triplet_slot_bwd2"] = (calls, L * b2)
    return out
