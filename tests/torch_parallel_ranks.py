"""Rank bodies of the port's multi-rank CPU tests: each runs in a spawned
process of a gloo group (``dig_tpu_torch.parallel.spawn_local``) and
returns numpy results to the test, which holds them against the JAX
package computed in the pytest process. This module imports neither jax
nor dig_tpu, so the children start fast."""
import threading

import torch

from dig_tpu_torch.convert import gp_model_from_flax, schnet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader
from dig_tpu_torch.models import SchNet
from dig_tpu_torch.parallel import (build_partitions, concat_local_shards,
                                    ep_shard_params, halo_exchange_sum,
                                    halo_exchange_sum_ring, make_dp_eval_step,
                                    make_dp_train_step, make_ep_moe,
                                    make_gp_engine, make_mesh,
                                    make_pp_train_step, make_tp_eval_step,
                                    make_tp_train_step, pipeline_apply,
                                    pp_shard_params, shard_graph_batch,
                                    tp_shard)
from dig_tpu_torch.parallel import gp_models
from dig_tpu_torch.parallel.gp import node_class_loss, node_reg_loss
from dig_tpu_torch.parallel.halo import halo_exchange_allgather
from dig_tpu_torch.parallel.scaling import measure_gp_scaling
from dig_tpu_torch.train import collective_selfcheck

LOSSES = {"class": node_class_loss, "reg": node_reg_loss}


def background(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` in a thread of the calling process (the
    tests start a spawn and compute the JAX side meanwhile); the returned
    callable waits for it and returns its result, or raises its error."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except Exception as exc:        # raised again by the caller
            box["err"] = exc
    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def _np(t):
    return t.detach().cpu().numpy()


def _batches(shard_mols, per, pad):
    return [next(iter(MoleculeLoader(m, per, n_node_pad=pad, device="cpu")))
            for m in shard_mols]


def _schnet(kw, flat):
    return schnet_from_flax(flat, SchNet(device="cpu", **kw))


def _weights(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


# -- DP, the halo exchanges, the mesh self-check, the scaling probe --------

def dp_halo(rank, world, spec):
    mesh2 = make_mesh((2, world // 2), ("data", "graph"))
    out = {"selfcheck": collective_selfcheck(mesh2),
           # the probe at P = world // 2 on each data row's graph group
           "scaling_half": measure_gp_scaling(world // 2, n_local=128, k=4,
                                              mesh=mesh2["graph"])}
    mesh = make_mesh((world,), ("data",))
    d = spec["dp"]
    model = _schnet(d["kw"], d["flat"])
    opt = torch.optim.SGD(model.parameters(), lr=d["lr"])
    g = shard_graph_batch(concat_local_shards(
        _batches(d["mols"], d["per"], d["pad"])), mesh)
    aux = make_dp_train_step(model, opt, mesh)(g)
    out["dp_loss"] = float(aux["loss"])
    out["dp_weights"] = _weights(model)
    evm = _schnet(d["kw"], d["flat"])
    out["dp_eval"] = _np(make_dp_eval_step(evm, mesh)(g)[0])

    h = spec["halo"]
    pg = build_partitions(h["s"], h["r"], h["n"], world)
    sums = {}
    for name, fn in (("a2a", halo_exchange_sum),
                     ("ring", halo_exchange_sum_ring)):
        x = torch.tensor(h["x_parts"][rank], requires_grad=True)
        y = fn(x, pg, mesh, "data")
        (gx,) = torch.autograd.grad(
            torch.sum(y * torch.tensor(h["ct_parts"][rank])), x)
        sums[name] = (_np(y), _np(gx))
    out["halo_sums"] = sums
    x = torch.tensor(h["x_parts"][rank], requires_grad=True)
    halo = halo_exchange_allgather(
        x, torch.tensor(pg.halo_src_part[rank]),
        torch.tensor(pg.halo_src_slot[rank]),
        torch.tensor(pg.halo_mask[rank]), mesh.get_group("data"))
    (gx,) = torch.autograd.grad(torch.sum(halo), x)
    out["halo_gather"] = (_np(halo), _np(gx))
    out["scaling"] = measure_gp_scaling(world, n_local=128, k=4, mesh=mesh)
    return out


# -- graph parallelism ------------------------------------------------------

def _gp_module(name, kw):
    return getattr(gp_models, name)(**kw)


def _engine_run(mesh, case, axis, data_axis=None):
    module = gp_model_from_flax(case["vars"], _gp_module(case["model"],
                                                         case["kw"]))
    opt = torch.optim.Adam(module.parameters(), lr=case["lr"])
    init_fn, step, predict = make_gp_engine(
        mesh, module, opt, case["H"], case["C"],
        loss_fn=LOSSES[case["loss"]], axis=axis, data_axis=data_axis)
    init_fn(case["x"], case["g"])
    pred = _np(predict(case["g"], case["x"]))
    losses, outs = [], []
    for _ in range(case.get("steps", 1)):
        loss, o = step(case["g"], case["x"], case["y"], case["mask"])
        losses.append(float(loss))
        outs.append(_np(o))
    return {"pred": pred, "losses": losses, "out": outs[0],
            "weights": _weights(module)}


def gp(rank, world, spec):
    out = {}
    mesh = make_mesh((world,), ("data",))
    for name, case in spec["one_d"].items():
        out[name] = _engine_run(mesh, case, "data")
    mesh2 = make_mesh((2, world // 2), ("data", "graph"))
    out["two_d"] = _engine_run(mesh2, spec["two_d"], "graph", "data")
    # the same modules on one part a rank: each rank a replica row of a
    # (world, 1) mesh computes the whole graph
    mesh1 = make_mesh((world, 1), ("data", "graph"))
    for name, case in spec["single"].items():
        out[f"{name}_single"] = _engine_run(mesh1, case, "graph", "data")
    return out


# -- tensor, pipeline and expert parallelism --------------------------------

def _pp_layer(pl, h):
    return h + torch.tanh(h @ pl["w"] + pl["b"])


def tp_pp_ep(rank, world, spec):
    out = {}
    t = spec["tp"]
    mesh = make_mesh((2, world // 2), ("data", "model"))
    g = shard_graph_batch(concat_local_shards(
        _batches(t["mols"], t["per"], t["pad"])), mesh, "data")
    for eaf in (False, True):
        model = tp_shard(_schnet(t["kw"], t["flat"]), mesh)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_tp_train_step(model, opt, mesh, energy_and_force=eaf,
                                  p=1.0)
        out[f"tp_eval_{eaf}"] = _np(make_tp_eval_step(model, mesh)(g)[0])
        losses = [float(step(g)["loss"]) for _ in range(3)]
        with torch.no_grad():
            full = {**{k: v for k, v in model.module.named_parameters()
                       if v.numel()}, **model.full_parameters()}
        out[f"tp_{eaf}"] = {"losses": losses,
                            "weights": {k: _np(v) for k, v in full.items()},
                            "n_shards": len(model.shards),
                            "shard_numel": sum(v.numel() for v in
                                               model.shards.values())}

    p = spec["pp"]
    mesh = make_mesh((world,), ("pipe",))
    params = pp_shard_params({k: torch.tensor(v) for k, v in
                              p["params"].items()}, mesh)
    x = torch.tensor(p["x"])
    with torch.no_grad():
        out["pp_outs"] = _np(pipeline_apply(_pp_layer, mesh)(params, x))
    opt = torch.optim.SGD(list(params.values()), lr=1e-2)
    step = make_pp_train_step(_pp_layer, opt, mesh,
                              lambda o, y: torch.mean((o - y) ** 2))
    out["pp_loss"] = float(step(params, x, torch.tensor(p["y"])))
    out["pp_params"] = {k: _np(v) for k, v in params.items()}

    e = spec["ep"]
    mesh = make_mesh((world,), ("expert",))
    b = e["x"].shape[0] // world
    x = torch.tensor(e["x"][rank * b:(rank + 1) * b])
    res = {}
    for cap in e["caps"]:
        local = ep_shard_params({k: torch.tensor(v) for k, v in
                                 e["params"].items()}, mesh)
        y, dropped = make_ep_moe(mesh, e["E"], cap)(local, x)
        grads = torch.autograd.grad(torch.sum(y ** 2), list(local.values()))
        res[cap] = {"y": _np(y), "dropped": int(dropped),
                    "grads": {k: _np(gr) for k, gr in zip(local, grads)}}
    out["ep"] = res
    return out
