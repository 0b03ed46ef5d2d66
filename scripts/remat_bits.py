"""Where remat changes the bits of a bf16 force step on the card.

    python scripts/remat_bits.py [SETTING ...]

Takes path 3's force step (chip_smoke.py: SphereNet 4 x 128 on the slot
kernels, bf16, its 29-atom bucket) from the same seeded state with remat
off and on, each in a fresh process (chip_smoke.py --remat-step), under
three settings (or those named on the command line): as shipped; with
every first-order backward computing the rows' cotangent (``_grad_wanted``
always true, the earlier rule); and with cuBLAS's reduced-precision bf16
reduction off. Prints, per setting,
whether the losses are the same bits, the launch counts of both steps
and which parameters' gradients differ. Then ``traced``: the same pair
with every module's outputs hashed as they are made (the first forward,
and remat's recomputations apart) and the gradient reaching each of them
hashed as it arrives, in the force pass (``torch.autograd.grad``) and in
the loss's backward; prints the first module output and the first gradient
of each pass whose bits part, in the order the step without remat makes
them, and the records one step has and the other lacks. Then, from the
gradient that parts first (``update_es.0[1]``, UpdateE 0's second output,
in the loss's backward), a walk up the autograd graph, every node
between the loss and it hooked and the gradients it receives and passes
on hashed: the node where the bits part, and whether it gets other
contributions, the same ones in another order, or the same gradient
with other bits out. Needs one CUDA card; builds the two kernel libraries
the step uses.
"""
import hashlib
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = ("shipped", "rows_cotangent_always", "no_reduced_precision")


def _digest(t):
    """A hash of the tensor's bits (2-byte types read as int16)."""
    import torch
    t = t.detach().contiguous()
    raw = t.view(torch.int16) if t.element_size() == 2 else t
    return hashlib.sha1(raw.cpu().numpy().tobytes()).hexdigest()


def _device_digest(t):
    """A position-weighted sum of the tensor's bits, left on the device
    (no sync a call): equal bits give equal sums."""
    import torch
    if t is None:
        return None
    x = t.detach().contiguous().view(-1)
    x = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]).to(torch.int64)
    w = torch.arange(1, x.numel() + 1, device=x.device) * 2654435761 \
        % 4294967291
    return torch.stack([(x * w).sum(), x.sum(),
                        torch.tensor(x.numel(), device=x.device)])


def _seq(node):
    return getattr(node, "_sequence_nr", lambda: -1)()


class Tracer:
    """Hashes each module's tensor outputs as they are made and the
    gradient reaching each as it arrives, with the pass it arrives in:
    ``force`` inside ``torch.autograd.grad``, ``loss`` after it. Records
    are (kind, module, pass, occurrence, shape, digest, norm).

    For the loss's backward, ``graph`` holds every autograd node whose
    gradient flows on into ``TARGET`` (the first forward's output of that
    name): its name, sequence number, edges into the others, the order
    it ran in, and digests of the gradient it received (``incoming``) and
    of each gradient it passed on along those edges (``outgoing``).
    ``seqs`` maps module outputs to their nodes' sequence numbers."""

    TARGET = "update_es.0[1]"

    def __init__(self, torch, model):
        self.torch, self.records, self.count = torch, [], {}
        self.phase = "forward"
        self.target, self.graph, self.seqs, self.fired = None, None, [], 0
        for name, mod in model.named_modules():
            if name:
                mod.register_forward_hook(self._forward(name))
        grad = torch.autograd.grad

        def traced_grad(*a, **k):
            self.phase = "force"
            try:
                return grad(*a, **k)
            finally:
                self.phase = "loss"
        torch.autograd.grad = traced_grad
        backward = torch.Tensor.backward

        def traced_backward(t, *a, **k):
            self._hook_upstream(t)
            return backward(t, *a, **k)
        torch.Tensor.backward = traced_backward

    def _hook_upstream(self, root):
        """Hook every node between ``root`` and the target's node."""
        if self.target is None:
            return
        target = self.target.grad_fn
        keep, fed, stack = {}, {}, [root.grad_fn]
        while stack:
            n = stack.pop()
            if n is None or id(n) in keep:
                continue
            keep[id(n)] = n
            for j, (m, _) in enumerate(n.next_functions):
                if m is not None:
                    fed.setdefault(id(m), []).append(n)
                    stack.append(m)
        up, stack = {id(target)}, [target]
        while stack:
            for p in fed.get(id(stack.pop()), ()):
                if id(p) not in up:
                    up.add(id(p))
                    stack.append(p)
        ids = {k: i for i, k in enumerate(up)}
        nodes = {}
        for k in up:
            n = keep[k]
            edges = [(j, ids[id(m)]) for j, (m, _) in enumerate(
                n.next_functions) if m is not None and id(m) in up]
            rec = nodes[ids[k]] = {"name": n.name(), "seq": _seq(n),
                                   "edges": edges, "order": None,
                                   "incoming": None, "outgoing": None}
            n.register_hook(self._node_hook(rec, [j for j, _ in edges]))
        self.graph = {"target": ids[id(target)], "nodes": nodes}

    def _node_hook(self, rec, js):
        def hook(grad_inputs, grad_outputs):
            rec["order"] = self.fired
            self.fired += 1
            rec["incoming"] = [_device_digest(g) for g in grad_outputs]
            rec["outgoing"] = {j: _device_digest(grad_inputs[j]) for j in js}
        return hook

    def result(self):
        """The records, the module outputs' sequence numbers and the
        graph, digests read back to the host."""
        def host(d):
            return None if d is None else tuple(d.tolist())
        graph = self.graph
        if graph is not None:
            for rec in graph["nodes"].values():
                if rec["incoming"] is not None:
                    rec["incoming"] = [host(d) for d in rec["incoming"]]
                    rec["outgoing"] = {j: host(d)
                                       for j, d in rec["outgoing"].items()}
        return {"records": self.records, "seqs": self.seqs, "graph": graph}

    def _note(self, kind, name, phase, t):
        key = (kind, name, phase)
        i = self.count[key] = self.count.get(key, -1) + 1
        self.records.append((kind, name, phase, i, tuple(t.shape),
                             _digest(t), float(t.detach().float().norm())))

    def _forward(self, name):
        def hook(mod, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            grad_on = self.torch.is_grad_enabled()
            for j, t in enumerate(outs):
                if not isinstance(t, self.torch.Tensor):
                    continue
                label = f"{name}[{j}]"
                # the first forward, or a recomputation inside a backward
                self._note("output", label, self.phase if grad_on
                           else "no_grad", t)
                if t.grad_fn is not None:
                    self.seqs.append((label, self.phase, _seq(t.grad_fn)))
                if t.requires_grad:
                    t.register_hook(lambda g, label=label: self._note(
                        "grad", label, self.phase, g))
                if label == self.TARGET and self.phase == "forward":
                    self.target = t
        return hook


def one_step(setting, flag, out):
    """One step in this process under ``setting``, remat ``flag``."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    if setting == "rows_cotangent_always":
        from dig_tpu_torch.ops import triplet_slot as ts
        ts._grad_wanted = lambda ctx, i: bool(ctx.needs_input_grad[i])
    if setting == "no_reduced_precision":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    if setting == "traced":
        chip_smoke.remat_step(flag, "bf16", out, trace=Tracer)
        return
    chip_smoke.remat_step(flag, "bf16", out)


def compare_traces(a, b):
    """The first record of each kind and pass of the step without remat
    (``a``) whose bits differ in the step with it (``b``), matched by
    (kind, module, pass, occurrence); then the records one has and the
    other lacks, by (kind, pass)."""
    ka = {r[:4]: r for r in a}
    kb = {r[:4]: r for r in b}
    firsts = {}
    for r in a:
        o = kb.get(r[:4])
        if o is not None and o[5] != r[5] and (r[0], r[2]) not in firsts:
            firsts[(r[0], r[2])] = (r, o)
    for (kind, phase), (r, o) in firsts.items():
        print(f"  first {kind} in the {phase} pass whose bits part: {r[1]} "
              f"(occurrence {r[3]}, shape {r[4]}; norm without remat "
              f"{r[6]:.6g}, with {o[6]:.6g})", flush=True)
    if not firsts:
        print("  every record both steps share has the same bits")
    first = {r[1]: r[5] for r in a
             if r[0] == "output" and r[2] == "forward" and r[3] == 0}
    again = [r for r in b if r[0] == "output" and r[2] in ("force", "loss")]
    same = sum(first.get(r[1]) == r[5] for r in again)
    print(f"  outputs recomputed in a backward (with remat): {same} of "
          f"{len(again)} have the bits of the first forward's", flush=True)
    for name, x, y in (("without remat only", ka, kb),
                       ("with remat only", kb, ka)):
        extra = {}
        for k in x:
            if k not in y:
                extra[(k[0], k[2])] = extra.get((k[0], k[2]), 0) + 1
        print(f"  records {name}: {extra}", flush=True)


def _module_near(seqs, seq):
    """The module output whose node was made first at or after ``seq``."""
    after = [(q, label, phase) for label, phase, q in seqs if q >= seq]
    return "after every module output" if not after else \
        "%s (%s pass)" % min(after)[1:]


def walk_to_cause(a, b):
    """From the target's node in both steps (``a`` without remat, ``b``
    with), up the graph to the node where the bits part: at each node, the
    nodes that feed it and the digests of what they pass on; stop where
    the feeders differ, where the same contributions arrive (their order
    parts the sums), or at a feeder that receives the same gradient in both
    steps and passes on other bits (its own backward differs)."""
    from collections import Counter
    A, B = a["graph"], b["graph"]
    if A is None or B is None:
        print("  no graph traced", flush=True)
        return

    def feeders(G):
        rev = {}
        for pid, rec in G["nodes"].items():
            for j, c in rec["edges"]:
                rev.setdefault(c, []).append((pid, j))
        return rev

    def describe(G, rev, x):
        out = []
        for p, j in rev.get(x, ()):
            rec = G["nodes"][p]
            d = rec["outgoing"].get(j) if rec["outgoing"] else None
            out.append((rec["name"], d, rec["order"], p))
        return out

    ra, rb = feeders(A), feeders(B)
    xa, xb, path = A["target"], B["target"], []
    if A["nodes"][xa]["incoming"] == B["nodes"][xb]["incoming"]:
        print("  the target's gradient has the same bits in both steps",
              flush=True)
        return
    while True:
        na, nb = A["nodes"][xa], B["nodes"][xb]
        here = (f"{na['name']} (seq {na['seq']} / {nb['seq']}, "
                f"{len(path)} nodes up from the target)")
        fa, fb = describe(A, ra, xa), describe(B, rb, xb)
        ca, cb = Counter(f[0] for f in fa), Counter(f[0] for f in fb)
        if ca != cb:
            print(f"  {here}: other feeders: without remat only "
                  f"{dict(ca - cb)}, with remat only {dict(cb - ca)}",
                  flush=True)
            break
        da, db = Counter(f[1] for f in fa), Counter(f[1] for f in fb)
        if da == db:
            order = lambda fs: [f[0] for f in sorted(
                fs, key=lambda f: -1 if f[2] is None else f[2])]
            print(f"  {here}: the same {len(fa)} contributions in both "
                  f"steps; they arrive without remat as {order(fa)}, with "
                  f"it as {order(fb)}", flush=True)
            break
        common = da & db

        def rest(fs):
            left, out = Counter(common), []
            for f in fs:
                if left[f[1]]:
                    left[f[1]] -= 1
                else:
                    out.append(f)
            return sorted(out, key=lambda f: (f[0], f[2] is None, f[2]))
        pairs = [(p, q) for p, q in zip(rest(fa), rest(fb)) if p[0] == q[0]]
        if not pairs:
            print(f"  {here}: the differing contributions come from other "
                  f"nodes: {[f[0] for f in rest(fa)]} / "
                  f"{[f[0] for f in rest(fb)]}", flush=True)
            break
        pa, pb = min(pairs, key=lambda pq: (pq[0][2] is None, pq[0][2]))
        path.append(pa[0])
        A_p, B_p = A["nodes"][pa[3]], B["nodes"][pb[3]]
        if A_p["incoming"] == B_p["incoming"]:
            kids = lambda G, rec: sorted(G["nodes"][c]["name"]
                                         for _, c in rec["edges"])
            print(f"  {pa[0]} (seq {A_p['seq']} / {B_p['seq']}, "
                  f"{len(path)} nodes up from the target; its node made "
                  f"before {_module_near(a['seqs'], A_p['seq'])} without "
                  f"remat, {_module_near(b['seqs'], B_p['seq'])} with it) "
                  f"receives the same gradient in both steps and passes on "
                  f"other bits (its own backward differs); it feeds "
                  f"{kids(A, A_p)} / {kids(B, B_p)} and is fed by "
                  f"{sorted(f[0] for f in describe(A, ra, pa[3]))} / "
                  f"{sorted(f[0] for f in describe(B, rb, pb[3]))}",
                  flush=True)
            break
        xa, xb = pa[3], pb[3]
    print(f"  the walk: {' <- '.join(path) or '(none)'}", flush=True)


def main():
    if sys.argv[1:2] == ["--step"]:
        one_step(*sys.argv[2:5])
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("remat_bits.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dig_tpu_torch.ops import _build
    chip_smoke.build_all(_build, {n: (n, None)
                                  for n in ("triplet_slot", "segment_csr")})
    with tempfile.TemporaryDirectory() as tmp:
        for setting in sys.argv[1:] or SETTINGS + ("traced",):
            runs = []
            for flag in ("0", "1"):
                out = os.path.join(tmp, f"{setting}_{flag}.pt")
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--step",
                     setting, flag, out], capture_output=True, text=True,
                    timeout=900)
                if res.returncode != 0:
                    sys.exit(f"{setting} remat {flag}: {res.stderr[-2000:]}")
                runs.append(torch.load(out))
            a, b = runs
            diff = [n for n in a["grad"]
                    if not torch.equal(a["grad"][n], b["grad"][n])]
            print(f"{setting}: loss the same bits "
                  f"{torch.equal(a['loss'], b['loss'])}; launches (slot "
                  f"forward, backward, backward with dpt, second order; "
                  f"segment sum) off {a['launches']}, on {b['launches']}; "
                  f"{len(diff)} of {len(a['grad'])} gradients differ: "
                  f"{diff}", flush=True)
            if setting == "traced":
                compare_traces(a["trace"]["records"],
                               b["trace"]["records"])
                walk_to_cause(a["trace"], b["trace"])


if __name__ == "__main__":
    main()
