"""Load parameter trees of the JAX package into the port's modules.

Parameters arrive as a flat ``{name: numpy array}`` dict, the names being
the flax tree's paths joined by ``/`` (``flax.traverse_util.flatten_dict(
params["params"], sep="/")``), so this module needs no JAX. Flax ``Dense``
kernels are ``[in, out]`` and are transposed into ``nn.Linear.weight``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .auggraph.graphaug import _GIN, Augmenter, RewardGMNet
from .auggraph.smixup import MatchNet
from .ggraph.jtmpn import JTMPNScorer
from .ggraph.jtvae import JTVAEModel
from .ggraph.models.graphaf import GraphFlowModelAF
from .ggraph.models.graphdf import GraphFlowModelDF
from .ggraph.models.graphebm import EnergyFunc
from .ggraph3d.gspherenet import SphGenModel
from .lsgraph.fm_ib import GraphFMIB
from .lsgraph.models import ScalableGNN
from .models.comenet import ComENet
from .models.pronet import ProNet
from .models.schnet import SchNet
from .models.schnet_dense import SchNetDense
from .models.spherenet import _SphericalMPNN
from .ssl.contrastive import ProjHead
from .ssl.encoders import GIN, PReLU, ResGCN
from .ssl.methods import DenseDiffusionEncoder
from .xgraph.models import GNNModel
from .xgraph.pgexplainer import _EdgeMLP


class _Tree:
    """A flat flax tree being consumed: ``take`` pops an entry, ``put``
    copies it into a parameter, ``finish`` raises on entries left unused
    or parameters of the model left unset."""

    def __init__(self, params: Dict[str, np.ndarray]):
        self.todo = dict(params)
        self.done = set()

    def take(self, name: str) -> torch.Tensor:
        if name not in self.todo:
            raise KeyError(f"flax tree lacks {name!r}")
        return torch.tensor(np.asarray(self.todo.pop(name), np.float32))

    def put(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
        self.done.add(id(dst))

    def dense(self, lin, name: str) -> None:
        """Flax ``Dense`` ``name`` (kernel [in, out], bias) into ``lin``."""
        self.put(lin.weight, self.take(f"{name}/kernel").T)
        if lin.bias is not None:
            self.put(lin.bias, self.take(f"{name}/bias"))

    def finish(self, model: torch.nn.Module) -> torch.nn.Module:
        if self.todo:
            raise KeyError(f"unused flax entries: {sorted(self.todo)}")
        unset = [n for n, p in model.named_parameters()
                 if id(p) not in self.done]
        if unset:
            raise KeyError(f"parameters not set from the flax tree: {unset}")
        return model


@torch.no_grad()
def schnet_dense_from_flax(params: Dict[str, np.ndarray],
                           model: SchNetDense) -> SchNetDense:
    """Copy a flax ``SchNetDense`` tree into ``model`` so both compute the
    same function. Takes either branch's tree: ``cf_w1_l``/``cf_b1_l``/
    ``cf_w2_l``/``cf_b2_l`` (``use_pallas=True``) or ``MLP_l/Dense_{0,1}``
    (the einsum branch); both land in the interaction's filter MLP. Every
    entry must be used and every parameter of ``model`` set."""
    t = _Tree(params)
    t.put(model.embedding.weight, t.take("Embed_0/embedding"))
    L = len(model.interactions)
    for l, layer in enumerate(model.interactions):
        t.dense(layer.lin_vj, f"Dense_{3 * l}")
        t.dense(layer.lin1, f"Dense_{3 * l + 1}")
        t.dense(layer.lin2, f"Dense_{3 * l + 2}")
        m1, m2 = layer.mlp.layers
        if f"cf_w1_{l}" in t.todo:
            t.put(m1.weight, t.take(f"cf_w1_{l}").T)
            t.put(m1.bias, t.take(f"cf_b1_{l}"))
            t.put(m2.weight, t.take(f"cf_w2_{l}").T)
            t.put(m2.bias, t.take(f"cf_b2_{l}"))
        else:
            t.dense(m1, f"MLP_{l}/Dense_0")
            t.dense(m2, f"MLP_{l}/Dense_1")
    t.dense(model.out1, f"Dense_{3 * L}")
    t.dense(model.out2, f"Dense_{3 * L + 1}")
    return t.finish(model)


@torch.no_grad()
def schnet_from_flax(params: Dict[str, np.ndarray], model: SchNet) -> SchNet:
    """Copy a flax (flat) ``SchNet`` tree into ``model``:
    ``SchNetInteraction_l/{MLP_0/Dense_{0,1}, Dense_0 (lin_vj), Dense_1,
    Dense_2}``, the readout ``Dense_0``, ``Dense_1`` and ``Embed_0``. Every
    entry must be used and every parameter of ``model`` set."""
    t = _Tree(params)
    t.put(model.embedding.weight, t.take("Embed_0/embedding"))
    for l, layer in enumerate(model.interactions):
        blk = f"SchNetInteraction_{l}/"
        for k, lin in enumerate(layer.mlp.layers):
            t.dense(lin, f"{blk}MLP_0/Dense_{k}")
        for k, lin in enumerate((layer.lin_vj, layer.lin1, layer.lin2)):
            t.dense(lin, f"{blk}Dense_{k}")
    t.dense(model.out1, "Dense_0")
    t.dense(model.out2, "Dense_1")
    return t.finish(model)


@torch.no_grad()
def spherenet_from_flax(params: Dict[str, np.ndarray],
                        model: _SphericalMPNN) -> _SphericalMPNN:
    """Copy a flax ``SphereNet`` / ``DimeNetPP`` tree into ``model``.

    Every layout and branch (flat, NK unfused, slot kernel) has the same
    parameters under the same flax names, so one tree loads into any of
    them. Dense kernels are transposed, ``DistEmb_0/freq`` and the
    ``Embed`` table copied. Every entry must be used and every parameter
    of ``model`` set."""
    t = _Tree(params)

    def denses(prefix, lins):
        for i, lin in enumerate(lins):
            t.dense(lin, f"{prefix}Dense_{i}")

    t.put(model.dist_emb.freq, t.take("DistEmb_0/freq"))
    t.put(model.init_block.embed.weight, t.take("InitBlock_0/Embed_0/embedding"))
    denses("InitBlock_0/", model.init_block.flax_denses())
    for i, uv in enumerate(model.update_vs):
        denses(f"UpdateV_{i}/", uv.flax_denses())
    for l, ue in enumerate(model.update_es):
        denses(f"UpdateE_{l}/", ue.flax_denses())
        for r, res in enumerate([*ue.before, *ue.after]):
            denses(f"UpdateE_{l}/ResidualLayer_{r}/", res.flax_denses())
    return t.finish(model)


def _denses(t: _Tree, prefix: str, lins) -> None:
    for i, lin in enumerate(lins):
        t.dense(lin, f"{prefix}Dense_{i}")


def _tll(t: _Tree, prefix: str, tll) -> None:
    _denses(t, prefix, tll.flax_denses())


@torch.no_grad()
def comenet_from_flax(params: Dict[str, np.ndarray],
                      model: ComENet) -> ComENet:
    """Copy a flax ``ComENet`` / ``ComENetOCP`` tree into ``model``: every
    layout has the same parameters under the same names (``Embed_0``,
    ``SimpleInteractionBlock_l/{Dense_i, TwoLayerLinear_{0,1},
    EdgeGraphConv_{0,1}, GraphNorm_0}``, the readout's ``Dense_i``). Every
    entry must be used and every parameter of ``model`` set."""
    t = _Tree(params)
    t.put(model.embed.weight, t.take("Embed_0/embedding"))
    for l, blk in enumerate(model.blocks):
        pre = f"SimpleInteractionBlock_{l}/"
        _denses(t, pre, blk.flax_denses())
        for c, (tll, conv) in enumerate(((blk.tll1, blk.conv1),
                                         (blk.tll2, blk.conv2))):
            _tll(t, f"{pre}TwoLayerLinear_{c}/", tll)
            _denses(t, f"{pre}EdgeGraphConv_{c}/", conv.flax_denses())
        for name in ("alpha", "gamma", "beta"):
            t.put(getattr(blk.norm, name), t.take(f"{pre}GraphNorm_0/{name}"))
    _denses(t, "", model.flax_denses())
    return t.finish(model)


@torch.no_grad()
def pronet_from_flax(params: Dict[str, np.ndarray], model: ProNet) -> ProNet:
    """Copy a flax ``ProNet`` tree into ``model`` (any level and layout):
    ``Embed_0`` (``aminoacid``) or the input ``Dense_0``,
    ``ProNetInteraction_b/{Dense_i, TwoLayerLinear_{0,1,2},
    EdgeGraphConv_{0,1,2}}``, the readout's ``Dense_i``. Every entry must
    be used and every parameter of ``model`` set."""
    t = _Tree(params)
    if model.level == "aminoacid":
        t.put(model.embed.weight, t.take("Embed_0/embedding"))
    for b, blk in enumerate(model.blocks):
        pre = f"ProNetInteraction_{b}/"
        _denses(t, pre, blk.flax_denses())
        for c, (tll, conv) in enumerate(zip(blk.tlls, blk.convs)):
            _tll(t, f"{pre}TwoLayerLinear_{c}/", tll)
            _denses(t, f"{pre}EdgeGraphConv_{c}/", conv.flax_denses())
    _denses(t, "", model.flax_denses())
    return t.finish(model)


@torch.no_grad()
def scalable_gnn_from_flax(params: Dict[str, np.ndarray],
                           model: ScalableGNN) -> ScalableGNN:
    """Copy a flax ``_ScalableBody`` tree (``ScalableGNN.init``'s) into
    ``model``'s body, any arch: ``_GCNLayer_i/Dense_0``; ``Dense_0`` (input),
    ``_GCN2Layer_i/Dense_0``, ``Dense_1`` (readout); ``_PNALayer_i/Dense_0``
    and the readout ``Dense_0`` (``pna``, ``pna_jk``). Every entry must be
    used and every parameter of ``model`` set."""
    t = _Tree(params)
    body = model.body
    names = {"gcn": "_GCNLayer", "gcn2": "_GCN2Layer"}.get(body.arch,
                                                           "_PNALayer")
    for i, layer in enumerate(body.layers):
        t.dense(layer.lin, f"{names}_{i}/Dense_0")
    if body.arch == "gcn2":
        t.dense(body.lin_in, "Dense_0")
        t.dense(body.lin_out, "Dense_1")
    elif body.arch != "gcn":
        t.dense(body.lin_out, "Dense_0")
    return t.finish(model)


@torch.no_grad()
def graphfm_ib_from_flax(params: Dict[str, np.ndarray],
                         model: GraphFMIB) -> GraphFMIB:
    """Copy a flax GraphFM-IB ``_Net`` tree into ``model``: ``lin_l_{i}``
    (with bias) and ``lin_r_{i}`` (without). Every entry must be used and
    every parameter of ``model`` set."""
    t = _Tree(params)
    for i in range(model.L):
        t.dense(model.lin_l[i], f"lin_l_{i}")
        t.dense(model.lin_r[i], f"lin_r_{i}")
    return t.finish(model)


def _gin_convs(t: _Tree, prefix: str, convs) -> None:
    for i, conv in enumerate(convs):
        t.dense(conv.lin1, f"{prefix}GINConv_{i}/Dense_0")
        t.dense(conv.lin2, f"{prefix}GINConv_{i}/Dense_1")
        if conv.eps is not None:
            t.put(conv.eps, t.take(f"{prefix}GINConv_{i}/eps"))


def _gcn_conv(t: _Tree, name: str, conv) -> None:
    t.put(conv.lin.weight, t.take(f"{name}/Dense_0/kernel").T)
    if conv.bias is not None:
        t.put(conv.bias, t.take(f"{name}/bias"))


def _bn(t: _Tree, name: str, bn) -> None:
    t.put(bn.scale, t.take(f"{name}/scale"))
    t.put(bn.bias, t.take(f"{name}/bias"))


def _ssl_stack(t: _Tree, p: str, enc) -> None:
    """The GIN / GCN / ResGCN stack ``enc`` from the entries under ``p``."""
    if isinstance(enc, ResGCN):
        nf = len(enc.feats)
        for j, lin in enumerate(list(enc.feats) + list(enc.fcs)):
            t.dense(lin, f"{p}Dense_{j}")
        for i, (bn, conv) in enumerate(zip(enc.bns, enc.convs)):
            _bn(t, f"{p}MaskedBatchNorm_{i}", bn)
            _gcn_conv(t, f"{p}GCNConv_{i}", conv)
        return
    if isinstance(enc, GIN):
        _gin_convs(t, p, enc.convs)
    else:
        for i, conv in enumerate(enc.convs):
            _gcn_conv(t, f"{p}GCNConv_{i}", conv)
    if isinstance(enc.act, PReLU):
        t.put(enc.act.alpha, t.take(f"{p}PReLU_0/alpha"))
    for i, bn in enumerate(enc.bns or ()):
        _bn(t, f"{p}MaskedBatchNorm_{i}", bn)


@torch.no_grad()
def ssl_encoder_from_flax(params: Dict[str, np.ndarray], model):
    """Copy a flax ssl ``Encoder`` tree (GIN / GCN / ResGCN under
    ``encoder/``: ``GINConv_i/Dense_{0,1}``, ``GCNConv_i/Dense_0`` and
    ``bias``, ``MaskedBatchNorm_i``, the shared ``PReLU_0``; ResGCN's
    ``Dense_j``, feature layers then fc layers) or a
    ``DenseDiffusionEncoder`` tree (``Dense_i``) into ``model``. Every
    entry must be used and every parameter of ``model`` set."""
    t = _Tree(params)
    if isinstance(model, DenseDiffusionEncoder):
        for i, lin in enumerate(model.lins):
            t.dense(lin, f"Dense_{i}")
    else:
        _ssl_stack(t, "encoder/", model.encoder)
    return t.finish(model)


@torch.no_grad()
def proj_head_from_flax(params: Dict[str, np.ndarray], head: ProjHead):
    """A flax ``ProjHead`` tree (``Dense_0``, and ``Dense_1`` for MLP)."""
    t = _Tree(params)
    t.dense(head.lin1, "Dense_0")
    if head.lin2 is not None:
        t.dense(head.lin2, "Dense_1")
    return t.finish(head)


def contrastive_from_flax(params, encoders, heads):
    """A JAX ``Contrastive`` parameter tree ``{"enc": [encoder trees],
    "pg": tree or None, "pn": tree or None}`` (each a flat flax dict) into
    the unique ``encoders`` (one per entry of ``enc``) and the ``heads``
    of ``Contrastive.make_heads``."""
    if len(params["enc"]) != len(encoders):
        raise ValueError(f"{len(params['enc'])} encoder trees for "
                         f"{len(encoders)} encoders")
    for p, e in zip(params["enc"], encoders):
        ssl_encoder_from_flax(p, e)
    for k in ("pg", "pn"):
        if (params.get(k) is None) != (heads.get(k) is None):
            raise ValueError(f"head {k}: the tree and the heads disagree")
        if heads.get(k) is not None:
            proj_head_from_flax(params[k], heads[k])
    return encoders, heads


@torch.no_grad()
def auggraph_from_flax(params: Dict[str, np.ndarray], model):
    """Copy a flax auggraph tree into ``model``: an ``Augmenter``
    (``_GIN_s`` and ``Dense_{3s, 3s+1, 3s+2}`` a step: category, node and
    edge heads), a ``RewardGMNet`` (``_GIN_0``, ``Dense_0``, ``Dense_1``),
    a ``MatchNet`` (``_GIN_0``), a ``_GIN`` (``GINConv_i``) or a runner's / SMixup's classifier
    (``_GIN_0``, ``Dense_0``)."""
    t = _Tree(params)
    if isinstance(model, Augmenter):
        for s in range(model.max_steps):
            _gin_convs(t, f"_GIN_{s}/", model.gins[s].convs)
            for j, lin in enumerate((model.cat[s], model.node[s],
                                     model.edge[s])):
                t.dense(lin, f"Dense_{3 * s + j}")
    elif isinstance(model, RewardGMNet):
        _gin_convs(t, "_GIN_0/", model.enc.convs)
        t.dense(model.lin1, "Dense_0")
        t.dense(model.lin2, "Dense_1")
    elif isinstance(model, MatchNet):
        _gin_convs(t, "_GIN_0/", model.enc.convs)
    elif isinstance(model, _GIN):
        _gin_convs(t, "", model.convs)
    else:
        _gin_convs(t, "_GIN_0/", model.gin.convs)
        t.dense(model.out, "Dense_0")
    return t.finish(model)


# ---------------------------------------------------------------------------
# ggraph: the converters take the flax variables ({"params": tree,
# "batch_stats": tree}, nested dicts of arrays, as jax.device_get gives them)
# ---------------------------------------------------------------------------

def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _vars(variables: Mapping):
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unknown flax collections: {sorted(extra)}")
    return (_Tree(_flatten(variables["params"])),
            _flatten(variables.get("batch_stats", {})))


def _gru(t: _Tree, name: str, gru) -> None:
    for g in ("ir", "iz", "in", "hr", "hz", "hn"):
        t.dense(getattr(gru, g), f"{name}/{g}")


def _flow_core(t: _Tree, stats: Dict[str, np.ndarray], core,
               rescales: bool) -> None:
    t.dense(core.rgcn.emb, "flow_core/rgcn/Dense_0")
    for k, conv in enumerate(core.rgcn.convs):
        t.put(conv.weight, t.take(f"flow_core/rgcn/RelGraphConv_{k}/weight"))
    t.put(core.bn.scale, t.take("flow_core/bn/scale"))
    t.put(core.bn.bias, t.take("flow_core/bn/bias"))
    left = dict(stats)
    for name in ("mean", "var"):
        key = f"flow_core/bn/{name}"
        if key not in left:
            raise KeyError(f"flax batch_stats lack {key!r}")
        getattr(core.bn, name).copy_(torch.tensor(left.pop(key)))
    if left:
        raise KeyError(f"unused flax batch_stats: {sorted(left)}")
    for kind in ("node_st", "edge_st"):
        for i, st in enumerate(getattr(core, kind)):
            p = f"flow_core/{kind}_{i}/"
            t.dense(st.lin1, p + "Dense_0")
            t.dense(st.lin2, p + "Dense_1")
            if rescales:
                t.put(st.rescale1.weight, t.take(p + "Rescale_0/weight"))
                t.put(st.rescale2.weight, t.take(p + "Rescale_1/weight"))


@torch.no_grad()
def graphdf_from_flax(variables: Mapping,
                      model: GraphFlowModelDF) -> GraphFlowModelDF:
    """A flax ``GraphFlowModelDF``'s variables (params and the batch
    norm's running statistics) into ``model``."""
    t, stats = _vars(variables)
    t.put(model.node_base_log_probs, t.take("node_base_log_probs"))
    t.put(model.edge_base_log_probs, t.take("edge_base_log_probs"))
    _flow_core(t, stats, model.flow_core, rescales=False)
    return t.finish(model)


@torch.no_grad()
def graphaf_from_flax(variables: Mapping,
                      model: GraphFlowModelAF) -> GraphFlowModelAF:
    """A flax ``GraphFlowModelAF``'s variables into ``model``."""
    t, stats = _vars(variables)
    _flow_core(t, stats, model.flow_core, rescales=True)
    return t.finish(model)


@torch.no_grad()
def graphebm_from_flax(variables: Mapping, model: EnergyFunc) -> EnergyFunc:
    """A flax ``EnergyFunc``'s variables (``EBMGraphConv_k``, ``Dense_0``)
    into ``model``."""
    t, _ = _vars(variables)
    for k, conv in enumerate(model.convs):
        t.put(conv.weight, t.take(f"EBMGraphConv_{k}/weight"))
        t.put(conv.bias, t.take(f"EBMGraphConv_{k}/bias"))
        if conv.self_lin is not None:
            t.dense(conv.self_lin, f"EBMGraphConv_{k}/Dense_0")
    t.dense(model.out, "Dense_0")
    return t.finish(model)


@torch.no_grad()
def jtvae_from_flax(variables: Mapping, model: JTVAEModel) -> JTVAEModel:
    """A flax ``JTVAEModel``'s variables into ``model`` (the property
    head too when ``model.predict_prop``)."""
    t, _ = _vars(variables)
    t.put(model.tree_enc.emb.weight, t.take("tree_enc/Embed_0/embedding"))
    _gru(t, "tree_enc/GRUCell_0", model.tree_enc.gru)
    g = model.graph_enc
    t.put(g.emb.weight, t.take("graph_enc/Embed_0/embedding"))
    t.dense(g.lin0, "graph_enc/Dense_0")
    for k, lin in enumerate(g.lins):
        t.dense(lin, f"graph_enc/Dense_{k + 1}")
    for name in ("t_mean", "t_logvar", "g_mean", "g_logvar", "dec_label",
                 "dec_topo", "dec_init") + (
                     ("prop_nn1", "prop_nn2") if model.predict_prop else ()):
        t.dense(getattr(model, name), name)
    t.put(model.dec_emb.weight, t.take("dec_emb/embedding"))
    _gru(t, "dec_gru", model.dec_gru)
    return t.finish(model)


@torch.no_grad()
def jtmpn_from_flax(variables: Mapping, model: JTMPNScorer) -> JTMPNScorer:
    """A flax ``JTMPNScorer``'s variables (``Dense_0`` the input layer,
    ``Dense_1..depth`` the messages, then the pooled and output layers)
    into ``model``."""
    t, _ = _vars(variables)
    lins = [model.lin0, *model.msgs, model.pool, model.out]
    for k, lin in enumerate(lins):
        t.dense(lin, f"Dense_{k}")
    return t.finish(model)


# ---------------------------------------------------------------------------
# ggraph3d and xgraph (flax variables as above)
# ---------------------------------------------------------------------------

@torch.no_grad()
def gspherenet_from_flax(variables: Mapping,
                         model: SphGenModel) -> SphGenModel:
    """A flax ``SphGenModel``'s variables into ``model``: the encoder
    (``Embed_0``; per layer ``l`` the filter ``Dense_{3l}``, the update's
    outer ``Dense_{3l+1}`` and inner ``Dense_{3l+2}``, flax's order of
    construction), the type embedding, the focus MLP, the four attentions
    (``Dense_0..3``: query, key, value, output) and the four flows."""
    t, _ = _vars(variables)
    enc = model.encoder
    t.put(enc.emb.weight, t.take("encoder/Embed_0/embedding"))
    for l, (w, u1, u2) in enumerate(zip(enc.filters, enc.upd1, enc.upd2)):
        t.dense(w, f"encoder/Dense_{3 * l}")
        t.dense(u2, f"encoder/Dense_{3 * l + 1}")
        t.dense(u1, f"encoder/Dense_{3 * l + 2}")
    t.put(model.type_emb.weight, t.take("type_emb/embedding"))
    for i, lin in enumerate(model.focus_mlp):
        t.dense(lin, f"focus_mlp_{i}")
    for kind in ("node", "dist", "angle", "torsion"):
        att = getattr(model, f"{kind}_att")
        for i, lin in enumerate((att.q, att.k, att.v, att.out)):
            t.dense(lin, f"{kind}_att/Dense_{i}")
        for i, st in enumerate(getattr(model, f"{kind}_flow")):
            t.dense(st.lin1, f"{kind}_flow_{i}/Dense_0")
            t.dense(st.lin2, f"{kind}_flow_{i}/Dense_1")
    return t.finish(model)


@torch.no_grad()
def xgraph_from_flax(variables: Mapping, model: GNNModel) -> GNNModel:
    """A flax ``GNNModel``'s variables (``XGCNConv_i`` / ``XGINConv_i``,
    the head's ``Dense_0``, ``Dense_1``) into ``model``, built first for
    the tree's input width (on the CPU when it had no layers)."""
    t, _ = _vars(variables)
    conv = "XGCNConv" if model.gnn == "gcn" else "XGINConv"
    in_dim = int(np.shape(t.todo[f"{conv}_0/Dense_0/kernel"])[0])
    if model.in_dim != in_dim:
        dev = (next(model.parameters()).device if model.in_dim is not None
               else "cpu")
        model.build(in_dim, device=dev)
    for i, c in enumerate(model.convs):
        if model.gnn == "gcn":
            t.dense(c.lin, f"{conv}_{i}/Dense_0")
            t.put(c.bias, t.take(f"{conv}_{i}/bias"))
        else:
            t.dense(c.lin1, f"{conv}_{i}/Dense_0")
            t.dense(c.lin2, f"{conv}_{i}/Dense_1")
    for i, lin in enumerate(model.head):
        t.dense(lin, f"Dense_{i}")
    return t.finish(model)


@torch.no_grad()
def pgexplainer_from_flax(variables: Mapping, mlp: _EdgeMLP) -> _EdgeMLP:
    """A flax ``_EdgeMLP``'s variables (``Dense_0``, ``Dense_1``) into
    ``mlp``."""
    t, _ = _vars(variables)
    t.dense(mlp.lin1, "Dense_0")
    t.dense(mlp.lin2, "Dense_1")
    return t.finish(mlp)


# ---------------------------------------------------------------------------
# fairgraph
# ---------------------------------------------------------------------------

@torch.no_grad()
def graphair_from_flax(params: Mapping, model):
    """The four flax trees of a JAX ``Graphair`` (``fit_whole``'s
    ``{"aug", "enc", "adv", "proj"}``, each the module's variables) into a
    port ``Graphair``'s modules, for ``prepare`` and the step functions
    (``fit_whole`` draws its own weights)."""
    t, _ = _vars(params["aug"])
    aug = model.aug
    t.dense(aug.body.layers[0], "GCNBody_0/Dense_0")
    t.dense(aug.edge_out, "Dense_0")
    t.dense(aug.edge_in, "Dense_1")
    t.dense(aug.mask_out, "Dense_2")
    t.dense(aug.mask_in, "Dense_3")
    t.finish(aug)
    t, _ = _vars(params["enc"])
    for i, lin in enumerate(model.enc.layers):
        t.dense(lin, f"Dense_{i}")
    t.finish(model.enc)
    t, _ = _vars(params["adv"])
    t.dense(model.adv.lin1, "Dense_0")
    t.dense(model.adv.lin2, "Dense_1")
    t.finish(model.adv)
    t, _ = _vars(params["proj"])
    t.dense(model.proj.lin_out, "Dense_0")
    t.dense(model.proj.lin_in, "Dense_1")
    t.finish(model.proj)
    return model


@torch.no_grad()
def fair_classifier_from_flax(variables: Mapping, clf):
    """A flax ``fairgraph`` ``Classifier``'s variables into ``clf``."""
    t, _ = _vars(variables)
    t.dense(clf.lin, "Dense_0")
    return t.finish(clf)


# ---------------------------------------------------------------------------
# parallel: the graph-parallel models
# ---------------------------------------------------------------------------

@torch.no_grad()
def gp_model_from_flax(variables: Mapping, model):
    """A flax ``GPGCN`` / ``GPGCN2`` / ``GPPNA`` / ``GPSchNet``'s variables
    into the port's module of the same class and sizes."""
    from .parallel.gp_models import GPGCN, GPGCN2, GPPNA, GPSchNet
    t, _ = _vars(variables)
    if isinstance(model, GPGCN):
        for i, lin in enumerate(model.lins):
            t.dense(lin, f"Dense_{i}")
    elif isinstance(model, GPGCN2):
        lins = [model.lin_in, *model.convs, model.lin_out]
        for i, lin in enumerate(lins):
            t.dense(lin, f"Dense_{i}")
    elif isinstance(model, GPPNA):
        for i, lin in enumerate([*model.lins, model.lin_out]):
            t.dense(lin, f"Dense_{i}")
    elif isinstance(model, GPSchNet):
        t.put(model.embedding.weight, t.take("Embed_0/embedding"))
        for l, layer in enumerate(model.layers):
            t.dense(layer.lin_vj, f"Dense_{3 * l}")
            for k, lin in enumerate(layer.mlp.layers):
                t.dense(lin, f"MLP_{l}/Dense_{k}")
            t.dense(layer.lin1, f"Dense_{3 * l + 1}")
            t.dense(layer.lin2, f"Dense_{3 * l + 2}")
        L = len(model.layers)
        t.dense(model.out1, f"Dense_{3 * L}")
        t.dense(model.out2, f"Dense_{3 * L + 1}")
    else:
        raise TypeError(f"not a graph-parallel model: {type(model)}")
    return t.finish(model)
