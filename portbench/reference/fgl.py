"""Plain PyTorch reference of one SpreadFGL / FedGL global round, in f32.

A frozen copy of the equations the port computes (Algorithm 1 of the
paper, as ``repro_torch.core`` states them), written as ordinary tensor
code with no kernel, no batching over servers and nothing of the port:

- local training: GraphSAGE with the GCN (mean) aggregator on the dense
  row-normalised adjacency, masked cross-entropy (Eq. 7) plus, on a ring
  of servers, the trace-norm term of Eq. 15, T_l steps of Adam;
- imputation, every K rounds: the clients' softmax embeddings fused per
  server (Eq. 9), negative sampling (Eq. 13), the autoencoder {c,16,d} /
  {d,16,c} and the assessor {c,128,16,1} trained against each other
  (Eq. 13-14; the assessor the AE trains against is the one the round
  began with, and the assessor trains against the reconstruction after
  the first outer iteration), X̅ = f(S), the cross-client similarity top-k
  of H Hᵀ, and the patcher that wires each client's ``aug_max`` strongest
  links into its imputation slots;
- aggregation: Eq. 16 over the server adjacency (FedAvg on one server);
- evaluation: the mean client loss, accuracy and macro-F1 on test nodes.

Every product goes through :func:`mm`. With ``tf32=True`` it rounds both
operands (and, backwards, the incoming gradient) to TF32's 10-bit mantissa
and sums in f32, as the tensor cores do: the lower-precision control.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

EPS = 1e-6            # the assessor's log guard (Eq. 13-14)
ADAM = (0.9, 0.999, 1e-8)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).transpose(-1, -2), tf32_round(a).transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts and lists of tensors, as the port nests them.
# ---------------------------------------------------------------------------

def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{dotted path: tensor}`` of a nested dict / list tree."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tree_map(fn: Callable, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def grad_of(loss_fn: Callable, tree):
    with torch.enable_grad():
        flat = leaves(tree)
        live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        grads = torch.autograd.grad(loss_fn(_rebuild(tree, live)), list(live.values()))
    return _rebuild(tree, dict(zip(live, grads)))


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return flat[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return [_rebuild(v, flat, f"{prefix}.{i}" if prefix else str(i)) for i, v in enumerate(tree)]


@dataclasses.dataclass
class AdamState:
    step: int
    mu: Dict
    nu: Dict


def adam_init(tree) -> AdamState:
    return AdamState(0, tree_map(torch.zeros_like, tree), tree_map(torch.zeros_like, tree))


def adam_update(grads, state: AdamState, params, lr: float):
    """One Adam step. The bias corrections ``1 - b ** t`` are computed in the
    parameters' type, as the engine states them (``t`` a float32 step)."""
    b1, b2, eps = ADAM
    step = state.step + 1
    g, m, v, p = (leaves(t) for t in (grads, state.mu, state.nu, params))
    t = torch.tensor(float(step), dtype=next(iter(p.values())).dtype)
    c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    new_m = {k: b1 * m[k] + (1 - b1) * g[k] for k in g}
    new_v = {k: b2 * v[k] + (1 - b2) * (g[k] * g[k]) for k in g}
    new_p = {k: p[k] - lr * ((new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + eps)) for k in g}
    return (_rebuild(params, new_p),
            AdamState(step, _rebuild(params, new_m), _rebuild(params, new_v)))


# ---------------------------------------------------------------------------
# The classifier (Eq. 1-3, 7, 15).
# ---------------------------------------------------------------------------

def normalized_adjacency(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    a = adj * (node_mask[..., :, None] * node_mask[..., None, :])
    return a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)


def sage_logits(params, x, a_norm, node_mask, tf32: bool, agg1=None):
    """Logits [M, n, c]. ``agg1``, layer 1's neighbour mean of the masked
    features, may be passed in: it depends on the batch alone."""
    h = x * node_mask[..., None]
    layers = params["layers"]
    for li, layer in enumerate(layers):
        agg = agg1 if (li == 0 and agg1 is not None) else mm(a_norm, h, tf32)
        h = mm(h, layer["w_self"], tf32) + mm(agg, layer["w_nbr"], tf32) + layer["b"][:, None, :]
        if li < len(layers) - 1:
            h = torch.relu(h)
        h = h * node_mask[..., None]
    return h


def client_losses(params, logits, batch, trace_reg: float) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    y = batch["y"]
    picked = torch.gather(logp, -1, torch.clamp_min(y, 0).long()[..., None])[..., 0]
    mask = batch["train_mask"] * (y >= 0)
    loss = -(picked * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1.0)
    if trace_reg > 0:
        last = params["layers"][-1]
        loss = loss + trace_reg * sum((w * w).sum((-2, -1)) for k, w in last.items() if k != "b")
    return loss


def evaluate(params, batch, a_norm, trace_reg: float, tf32: bool) -> Tuple[float, float, float]:
    logits = sage_logits(params, batch["x"], a_norm, batch["node_mask"], tf32)
    y, c = batch["y"], logits.shape[-1]
    pred = logits.argmax(-1)
    mask = batch["test_mask"] * (y >= 0)
    acc = ((pred == y) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    op = torch.nn.functional.one_hot(pred, c).float() * mask[..., None]
    oy = torch.nn.functional.one_hot(torch.clamp_min(y, 0).long(), c).float() * mask[..., None]
    tp, fp, fn = ((op * oy).sum((0, 1)), (op * (1 - oy)).sum((0, 1)),
                  ((1 - op) * oy).sum((0, 1)))
    prec = tp / torch.clamp_min(tp + fp, 1e-9)
    rec = tp / torch.clamp_min(tp + fn, 1e-9)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-9)
    seen = (tp + fn) > 0
    macro = torch.where(seen, f1, 0.0).sum() / torch.clamp_min(seen.sum(), 1.0)
    loss = client_losses(params, logits, batch, trace_reg).sum() / y.shape[0]
    return float(loss), float(acc), float(macro)


# ---------------------------------------------------------------------------
# The imputation generator (Eq. 9-14).
# ---------------------------------------------------------------------------

def dense(layer, x, tf32):
    return mm(x, layer["w"], tf32) + layer["b"]


def encode(ae, s, tf32):
    return dense(ae["enc"][1], torch.relu(dense(ae["enc"][0], s, tf32)), tf32)


def reconstruct(ae, s, tf32):
    x_bar = encode(ae, s, tf32)
    logits = dense(ae["dec"][1], torch.relu(dense(ae["dec"][0], x_bar, tf32)), tf32)
    return x_bar, torch.softmax(logits, -1)


def assess(asr, h, tf32):
    z = h
    for li, layer in enumerate(asr["layers"]):
        z = dense(layer, z, tf32)
        if li < len(asr["layers"]) - 1:
            z = torch.relu(z)
    return torch.sigmoid(z[..., 0])


def masked_mean(v, mask):
    return (v * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1.0)


def train_generator(ae, ae_opt, asr, as_opt, h_real, fmask, s, cfg: Dict, tf32: bool,
                    first: Optional[Dict] = None):
    """One server's adversarial AE / assessor training (Algorithm 1 l. 16-23).
    ``first``, when given, receives the gradient of the first AE step and of
    the first assessor step under ``"ae"`` and ``"assessor"``."""
    fgl = cfg["fgl"]
    lr = float(fgl["lr_generator"])
    e = (h_real > 1.0 / h_real.shape[-1]).float()

    def ae_loss(p, frozen):
        _, h_fake = reconstruct(p, s, tf32)
        adv = torch.log1p(-assess(frozen, h_fake * e, tf32) + EPS)
        neg = (h_real - h_fake) * (1.0 - e)
        return masked_mean(adv + (neg * neg).sum(-1), fmask)

    def as_loss(p, h_fake):
        per = (torch.log1p(-assess(p, h_real * e, tf32) + EPS)
               + torch.log(assess(p, h_fake * e, tf32) + EPS))
        return masked_mean(per, fmask)

    def noted(name, grads):
        if first is not None and name not in first:
            first[name] = grads
        return grads

    frozen, h_fake = asr, None
    for _ in range(int(fgl["ae_outer_iters"])):
        for _ in range(int(fgl["ae_iters"])):
            g = noted("ae", grad_of(lambda p: ae_loss(p, frozen), ae))
            ae, ae_opt = adam_update(g, ae_opt, ae, lr)
        if h_fake is None:
            _, h_fake = reconstruct(ae, s, tf32)
        for _ in range(int(fgl["assessor_iters"])):
            g = noted("assessor", grad_of(lambda p: as_loss(p, h_fake), asr))
            asr, as_opt = adam_update(g, as_opt, asr, lr)
    return ae, ae_opt, asr, as_opt


def masked_gram_rows(h, rows: slice, row_client, client, target, tf32: bool) -> torch.Tensor:
    """Scores of rows ``rows`` of H against every candidate [r, n]: -inf on
    candidates of the row's own client or outside the target mask."""
    g = mm(h[rows], h.transpose(0, 1), tf32)
    keep = (row_client[rows, None] != client[None, :]) & (target[None, :] > 0)
    return torch.where(keep, g, -torch.inf)


def stable_topk(x, k):
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


@dataclasses.dataclass
class ServerLinks:
    """One server's similarity search over its flat slots ``[M_per * n_pad]``."""

    kth: torch.Tensor     # [n_flat] k-th best cross-client score of each row (-inf if none)
    vals: torch.Tensor    # [n_flat, k] the row's best scores, -inf where missing
    idx: torch.Tensor     # [n_flat, k] their flat indices, -1 where missing


def server_links(h, fmask, target, client, k: int, tf32: bool, block: int = 4096) -> ServerLinks:
    n = h.shape[0]
    vals, idx = [], []
    for lo in range(0, n, block):
        v, i = stable_topk(masked_gram_rows(h, slice(lo, min(lo + block, n)), client, client,
                                            target, tf32), k)
        vals.append(v)
        idx.append(i)
    vals, idx = torch.cat(vals), torch.cat(idx)
    valid = (fmask[:, None] > 0) & torch.isfinite(vals)
    vals = torch.where(valid, vals, -torch.inf)
    idx = torch.where(valid, idx, -1)
    return ServerLinks(kth=vals[:, -1], vals=vals, idx=idx)


# ---------------------------------------------------------------------------
# One round, and a run of rounds.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Choice:
    """The links a patcher wired into one round's imputation slots, per
    client and slot: ``ok`` [M, aug] bool, ``src`` [M, aug] local slot of
    the matched node, ``tgt`` [M, aug] the server-flat index of the imputed
    node (-1 where not ok); ``feats`` [M, aug, d], when given, the features
    written into the slots instead of the X̅ rows of ``tgt``."""

    ok: torch.Tensor
    src: torch.Tensor
    tgt: torch.Tensor
    feats: Optional[torch.Tensor] = None


class Reference:
    """Rounds of Algorithm 1 from the inputs a cell makes.

    ``inputs`` holds ``batch`` (the fields of the port's ``ClientBatch``),
    ``weights`` (``params``, ``ae``, ``assessor``), ``noise(t)`` and the
    layout: ``num_servers``, ``server_adjacency`` [N, N], ``aug_max``.
    """

    def __init__(self, cfg: Dict, traffic: Dict, inputs: Dict, tf32: bool = False):
        self.cfg, self.tf32 = cfg, tf32
        fgl = cfg["fgl"]
        self.k_links = int(fgl["top_k_links"])
        self.interval = int(traffic["imputation_interval"])
        self.local_rounds = int(fgl["local_rounds"])
        self.lr = float(fgl["lr_classifier"])
        self.n = int(inputs["num_servers"])
        self.spread = self.n > 1
        self.trace_reg = float(fgl["trace_reg"]) if self.spread else 0.0
        self.adj_servers = inputs["server_adjacency"]
        self.noise = inputs["noise"]
        self.batch = dict(inputs["batch"])
        self.aug = int(inputs["aug_max"])
        self.m = self.batch["x"].shape[0]
        self.mp = self.m // self.n
        self.n_pad = self.batch["x"].shape[1]
        self.n_local = self.n_pad - self.aug
        w = inputs["weights"]
        self.params = w["params"]
        self.opt = adam_init(self.params)
        self.ae = [tree_map(lambda t, j=j: t[j], w["ae"]) for j in range(self.n)]
        self.asr = [tree_map(lambda t, j=j: t[j], w["assessor"]) for j in range(self.n)]
        self.ae_opt = [adam_init(a) for a in self.ae]
        self.as_opt = [adam_init(a) for a in self.asr]
        self.round = 0
        self.grad0: Optional[Dict[str, torch.Tensor]] = None   # first local step's gradient
        self.gen_grad0: Optional[Dict[str, torch.Tensor]] = None   # first generator steps'
        self.links: Optional[List[ServerLinks]] = None
        self.x_bar: Optional[List[torch.Tensor]] = None
        self._refresh()

    def _refresh(self):
        b = self.batch
        self.a_norm = normalized_adjacency(b["adj"], b["node_mask"])
        self.agg1 = mm(self.a_norm, b["x"] * b["node_mask"][..., None], self.tf32)

    def _local(self):
        b = self.batch

        def loss(p):
            logits = sage_logits(p, b["x"], self.a_norm, b["node_mask"], self.tf32, self.agg1)
            return client_losses(p, logits, b, self.trace_reg).sum()

        for _ in range(self.local_rounds):
            grads = grad_of(loss, self.params)
            if self.grad0 is None:
                self.grad0 = {k: v.detach().float().cpu() for k, v in leaves(grads).items()}
            self.params, self.opt = adam_update(grads, self.opt, self.params, self.lr)

    def _generate(self, t: int):
        """The servers' generator round and similarity search; the patch is
        left to :meth:`patch`."""
        b = self.batch
        emb = torch.softmax(sage_logits(self.params, b["x"], self.a_norm, b["node_mask"],
                                        self.tf32, self.agg1), -1)
        s_all = self.noise(t)
        local = (torch.arange(self.n_pad, device=emb.device) < self.n_local).float()
        client = torch.arange(self.mp, device=emb.device).repeat_interleave(self.n_pad)
        self.links, self.x_bar, self.h_flat, self.fmask = [], [], [], []
        firsts = [{} for _ in range(self.n)]
        for j in range(self.n):
            sl = slice(j * self.mp, (j + 1) * self.mp)
            h = emb[sl].reshape(self.mp * self.n_pad, -1)
            fmask = b["node_mask"][sl].reshape(-1)
            self.ae[j], self.ae_opt[j], self.asr[j], self.as_opt[j] = train_generator(
                self.ae[j], self.ae_opt[j], self.asr[j], self.as_opt[j], h, fmask, s_all[j],
                self.cfg, self.tf32, firsts[j] if self.gen_grad0 is None else None)
            self.x_bar.append(encode(self.ae[j], s_all[j], self.tf32))
            self.h_flat.append(h)
            self.fmask.append(fmask)
            self.links.append(server_links(h, fmask, fmask * local.repeat(self.mp), client,
                                           self.k_links, self.tf32))
        if self.gen_grad0 is None:
            self.gen_grad0 = {f"{net}.{k}": v.detach().float().cpu()
                              for net in ("ae", "assessor")
                              for k, v in _stack([f[net] for f in firsts]).items()}

    def own_choice(self) -> Choice:
        """The patcher's choice from this reference's own links: each
        client's ``aug_max`` strongest links from its real local nodes,
        ties to the lowest (node, rank)."""
        ok, src, tgt = [], [], []
        for i in range(self.m):
            lk = self.links[i // self.mp]
            rows = slice((i % self.mp) * self.n_pad, (i % self.mp + 1) * self.n_pad)
            v, ix = lk.vals[rows], lk.idx[rows]
            real = (torch.arange(self.n_pad, device=v.device) < self.n_local) \
                & (self.batch["node_mask"][i] > 0)
            v = torch.where(real[:, None] & (ix >= 0), v, -torch.inf).reshape(-1)
            top_v, top_i = stable_topk(v, self.aug)
            ok.append(torch.isfinite(top_v))
            src.append(top_i // self.k_links)
            tgt.append(torch.where(ok[-1], ix.reshape(-1)[top_i], -1))
        return Choice(torch.stack(ok), torch.stack(src), torch.stack(tgt))

    def patch(self, choice: Choice):
        b = dict(self.batch)
        dev = b["x"].device
        nl, aug = self.n_local, self.aug
        x, adj, mask = b["x"].clone(), b["adj"].clone(), b["node_mask"].clone()
        adj[:, nl:, :] = 0.0
        adj[:, :, nl:] = 0.0
        for i in range(self.m):
            xb = self.x_bar[i // self.mp]
            okf = choice.ok[i].to(x.dtype)
            rows = (xb[torch.clamp_min(choice.tgt[i], 0)] if choice.feats is None
                    else choice.feats[i])
            x[i, nl:] = rows * okf[:, None]
            slots = nl + torch.arange(aug, device=dev)
            adj[i, choice.src[i], slots] = okf
            adj[i, slots, choice.src[i]] = okf
            mask[i, nl:] = okf
        b.update(x=x, adj=adj, node_mask=mask)
        self.batch = b
        self._refresh()

    def _aggregate(self):
        n, mp, a = self.n, self.mp, self.adj_servers

        def agg(leaf):
            client_sum = leaf.reshape((n, mp) + leaf.shape[1:]).sum(1)
            num = torch.einsum("rj,r...->j...", a, client_sum)
            w = num / (a.sum(0) * mp).reshape((n,) + (1,) * (leaf.ndim - 1))
            return torch.repeat_interleave(w, mp, dim=0)

        self.params = tree_map(agg, self.params)

    def step(self, choose: Optional[Callable[["Reference"], Choice]] = None) -> Dict:
        """One global round. On an imputation round ``choose(self)`` gives
        the patcher's choice (this reference's own when None). Returns the
        round's snapshot (see ``snapshot``)."""
        t = self.round
        with torch.no_grad():
            self._local()
            choice = None
            if t % self.interval == 0:
                self._generate(t)
                choice = (choose or Reference.own_choice)(self)
                self.patch(choice)
            self._aggregate()
            loss, acc, f1 = evaluate(self.params, self.batch, self.a_norm, self.trace_reg,
                                     self.tf32)
        self.round = t + 1
        snap = snapshot(loss, acc, f1, self.params, self.ae, self.asr, self.batch, self.aug)
        if t == 0:
            snap.update(grad0=self.grad0, gen_grad0=self.gen_grad0)
        return snap


def initial_snapshot(weights: Dict) -> Dict:
    """Snapshot 0: the inputs' weights, named as :func:`snapshot` names them."""
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in leaves(d).items()}  # noqa: E731
    return {"params": {**{f"params.{k}": v for k, v in cpu(weights["params"]).items()},
                       **{f"ae.{k}": v for k, v in cpu(weights["ae"]).items()},
                       **{f"assessor.{k}": v for k, v in cpu(weights["assessor"]).items()}}}


def _stack(trees: List) -> Dict:
    return {k: torch.stack([leaves(t)[k] for t in trees]) for k in leaves(trees[0])}


def snapshot(loss, acc, f1, params, ae, asr, batch, aug: int) -> Dict:
    """What the judge compares after a round, on the host: the evaluation,
    every leaf of the classifiers, autoencoders and assessors (servers
    stacked), and the imputation slots. The first round's also holds
    ``grad0``, the first local step's gradient, and ``gen_grad0``, the first
    AE and assessor steps' (servers stacked)."""
    ae_s = ae if isinstance(ae, dict) else _stack(ae)
    as_s = asr if isinstance(asr, dict) else _stack(asr)
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in leaves(d).items()}  # noqa: E731
    nl = batch["x"].shape[1] - aug
    return {
        "loss": float(loss), "acc": float(acc), "f1": float(f1),
        "params": {**{f"params.{k}": v for k, v in cpu(params).items()},
                   **{f"ae.{k}": v for k, v in cpu(ae_s).items()},
                   **{f"assessor.{k}": v for k, v in cpu(as_s).items()}},
        "aug": {"ok": (batch["node_mask"][:, nl:] > 0).cpu(),
                "src": batch["adj"][:, :nl, nl:].argmax(1).cpu(),
                "wired": batch["adj"][:, :nl, nl:].sum(1).cpu(),
                "x": batch["x"][:, nl:].detach().float().cpu()},
    }
