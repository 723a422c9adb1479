"""Plain full-batch GraphSAGE (mean aggregator) training and the comparison
that decides a training cell's ``correct``.

The reference is Hamilton et al.'s layer, h' = x W_self + mean over
in-neighbours of x W_nbr + b, ReLU between layers, the mean softmax
cross-entropy over the train vertices, and torch's Adam written out, on the
undirected simple graph of the edge list; the aggregation is a blocked
gather and ``index_add_`` with its transpose as the backward.  It starts
from the harness's initial weights and follows the program's first
``steps`` steps in float64.  The numbers compared:

- ``loss1_rel_gap``: the first step's loss, the relative gap (the later
  steps' losses swing from seed to seed by Adam's sign-like first update
  of near-zero gradient entries, as far as the control's: their drift is
  held by ``change_norm_gap``);
- ``grad_norm_gap``: the first gradient's norm per leaf (the program's read
  from Adam's first moment after step 1), the gap of norms over the larger
  of the reference leaf's norm and the median leaf's;
- ``change_norm_gap``: the same for each leaf's change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- ``logits_max_gap``: the first step's logits, the widest gap over the
  largest reference logit.

The control is this reference in float32 with every GEMM's operands
rounded to TF32 (10-bit mantissa, round to nearest even), the precision
below the float32 with TF32 off that the configuration states.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

from portbench.reference.graph import positions, pull_sum, undirected

LEAVES = ("w_self", "w_nbr", "b")


class _Pull(torch.autograd.Function):
    """y = A^T x over the stored edges; its gradient, A g."""

    @staticmethod
    def forward(ctx, x, s, d, n):
        ctx.save_for_backward(s, d)
        ctx.n = n
        return pull_sum(s, d, x, n)

    @staticmethod
    def backward(ctx, g):
        s, d = ctx.saved_tensors
        return pull_sum(d, s, g, ctx.n), None, None, None


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    """a @ b with TF32 operands forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return tf32(g) @ tf32(b).T, tf32(a).T @ tf32(g)


def forward(params, s, d, deg, x, mm=torch.matmul, agg_fault=None):
    h = x
    n = x.shape[0]
    for i, p in enumerate(params):
        nbr = _Pull.apply(h, s, d, n) / deg[:, None]
        if agg_fault is not None:
            nbr = agg_fault(i, nbr)
        out = mm(h, p["w_self"]) + mm(nbr, p["w_nbr"]) + p["b"]
        h = F.relu(out) if i + 1 < len(params) else out
    return h


def masked_cross_entropy(logits, labels, mask):
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def train(inputs: dict, device, *, dtype=torch.float64, tf32_gemms=False,
          mask=None, agg_fault=None) -> dict:
    """The first ``inputs['steps']`` steps from ``inputs['init']``: losses,
    first-gradient and change norms per leaf, and the first step's logits
    (rows in sorted external id order, ``rows``)."""
    src = torch.as_tensor(inputs["src"]).to(device)
    dst = torch.as_tensor(inputs["dst"]).to(device)
    ids, s, d = undirected(src, dst)
    del src, dst
    n = ids.numel()
    x = torch.as_tensor(inputs["x"]).to(device, dtype)
    if x.shape[0] != n:
        raise ValueError(f"features for {x.shape[0]} vertices, graph has {n}")
    labels = torch.as_tensor(inputs["labels"]).to(device, torch.int64)
    mask = torch.as_tensor(inputs["mask"] if mask is None else mask
                           ).to(device)
    deg = torch.clamp(torch.bincount(d, minlength=n).to(dtype), min=1e-12)
    params = [{k: torch.as_tensor(layer[k]).to(device, dtype).clone()
               .requires_grad_(True) for k in LEAVES}
              for layer in inputs["init"]]
    start = [{k: p[k].detach().clone() for k in LEAVES} for p in params]
    leaves = [(f"l{i}.{k}", p[k]) for i, p in enumerate(params)
              for k in LEAVES]
    mm = _Tf32Mm.apply if tf32_gemms else torch.matmul
    lr, (b1, b2), eps = inputs["lr"], inputs["betas"], inputs["eps"]
    m1 = [torch.zeros_like(t) for _, t in leaves]
    m2 = [torch.zeros_like(t) for _, t in leaves]
    out = {"losses": [], "rows": ids.cpu()}
    for step in range(1, inputs["steps"] + 1):
        logits = forward(params, s, d, deg, x, mm, agg_fault)
        loss = masked_cross_entropy(logits, labels, mask)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        if step == 1:
            out["logits"] = logits.detach()
            out["grad_norms"] = {name: float(torch.linalg.vector_norm(
                g.double())) for (name, _), g in zip(leaves, grads)}
        del logits
        out["losses"].append(loss.item())
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for (_, t), g, a, v in zip(leaves, grads, m1, m2):
                a.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                t.sub_(lr / bc1 * a / (v.sqrt() / bc2 ** 0.5 + eps))
    out["change_norms"] = {
        f"l{i}.{k}": float(torch.linalg.vector_norm(
            (p[k].detach() - start[i][k]).double()))
        for i, p in enumerate(params) for k in LEAVES}
    return out


def _worst(gaps) -> float:
    """The largest gap; infinite where any is NaN."""
    gaps = list(gaps)
    return math.inf if any(math.isnan(g) for g in gaps) else max(gaps)


def readings(ref: dict, got: dict) -> dict:
    """The four numbers compared, of ``got`` (the program's outputs, or a
    control's) against the reference's."""
    loss1 = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    if len(got["losses"]) != len(ref["losses"]):
        loss1 = math.inf
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    grad = _worst(abs(got["grad_norms"][k] - r) / max(r, med)
                  for k, r in g_ref.items())
    moved = [k for k, r in g_ref.items() if r >= 1e-3 * med]
    c_ref = ref["change_norms"]
    med_c = statistics.median(c_ref[k] for k in moved)
    change = _worst(abs(got["change_norms"][k] - c_ref[k])
                    / max(c_ref[k], med_c) for k in moved)
    z_ref = ref["logits"]
    rows = torch.as_tensor(got["rows"]).to(z_ref.device)
    pos, found = positions(ref["rows"].to(z_ref.device), rows)
    if bool(found.all()) and rows.numel() == z_ref.shape[0] and \
            torch.unique(pos).numel() == rows.numel():
        z = torch.as_tensor(got["logits"]).to(z_ref.device, z_ref.dtype)
        logit = float(torch.nan_to_num(
            torch.abs(z - z_ref[pos]).max(), nan=math.inf)
            / torch.abs(z_ref).max())
    else:
        logit = math.inf
    return {"loss1_rel_gap": _worst([loss1]), "grad_norm_gap": grad,
            "change_norm_gap": change, "logits_max_gap": logit}


def detail(ref: dict, got: dict) -> dict:
    """What the numbers are made of: each step's loss gap, each leaf's
    first-gradient and change gaps (over the same denominators)."""
    med = statistics.median(ref["grad_norms"].values())
    med_c = statistics.median(ref["change_norms"].values())
    return {
        "loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                          ref["losses"])],
        "grad_gaps": {k: abs(got["grad_norms"][k] - r) / max(r, med)
                      for k, r in ref["grad_norms"].items()},
        "change_gaps": {k: abs(got["change_norms"][k] - r) / max(r, med_c)
                        for k, r in ref["change_norms"].items()},
        "grad_norms": ref["grad_norms"], "change_norms": ref["change_norms"]}


def reference(judged, device) -> dict:
    return train(judged["inputs"], device)


def program_outputs(judged) -> dict:
    return judged["outputs"]



def control_outputs(judged, device) -> dict:
    """The control in the program's place: float32 with TF32 GEMMs."""
    return train(judged["inputs"], device, dtype=torch.float32,
                 tf32_gemms=True)


def fault_outputs(judged, device) -> dict:
    """The faults a training cell can have on one card, planted in the
    reference put in the program's place (float32): half of the batch left
    out, the mean over the rest; one answer altered where it is produced
    (the first aggregation's row of the busiest vertex doubled).  A step
    that leaves its state unchanged reads 1 on ``change_norm_gap`` by
    definition."""
    inputs = judged["inputs"]
    mask = torch.as_tensor(inputs["mask"]).clone()
    train_rows = torch.nonzero(mask)[:, 0]
    mask[train_rows[1::2]] = False
    half = train(inputs, device, dtype=torch.float32, mask=mask)
    src = torch.as_tensor(inputs["src"])
    dst = torch.as_tensor(inputs["dst"])
    busiest_row = int(torch.searchsorted(
        torch.unique(torch.cat([src, dst])), torch.mode(dst).values.reshape(1)))

    def doubled(layer, nbr):
        if layer:
            return nbr
        scale = torch.ones(nbr.shape[0], 1, dtype=nbr.dtype,
                           device=nbr.device)
        scale[busiest_row] = 2.0
        return nbr * scale

    altered = train(inputs, device, dtype=torch.float32, agg_fault=doubled)
    return {"half_batch": half, "altered_row": altered}
