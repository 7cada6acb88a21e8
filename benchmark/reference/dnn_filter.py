"""The plain reference of the DNN-filtered odometry configuration.

Upstream ICET's filtered solve (``python/ICET_spherical.py`` with
``DNN_filter=True``): from iteration ``dnn_start_iter`` on, before every
Gauss-Newton iteration, 100 points of each scan are sampled in every voxel,
a network predicts the voxel's translation between the scans in
``dnn_refine_steps`` refinement passes, and a voxel whose ICET mean
residual disagrees with it by more than ``dnn_thresh`` in the voxel's
compact frame is left out of the iteration.  Everything else is the plain
solve of :mod:`benchmark.reference.icet`, which this module imports and
does not change.  It imports nothing of the program.

What it computes, in plain PyTorch (float32; both TF32 switches off):

* the per-voxel "head" sample: each voxel's first S member points in scan
  order, the rows past its count filled with its first point;
* the network input: both samples centred on their joint mean, with a scan
  channel of -1 (scan 1) and +1 (scan 2);
* the network (:class:`Net`): three Dense + LayerNorm + ReLU stages of
  64, 128 and 256 features in bf16 (inputs and weights rounded to bf16,
  the products exact and summed in float32, rounded to bf16; the bf16
  bias added and rounded; LayerNorm statistics in float32 with the
  variance ``max(E[a^2] - mu^2, 0)``, eps 1e-6, in flax's order
  ``(a - mu) * (rsqrt(var + eps) * scale) + bias``, rounded to bf16; ReLU),
  the max over the points in bf16, then a float32 head of 128 and 64
  ReLU units and 3 outputs;
* the comparison: ``U diag(l) U^T (icet_shift - dnn_shift)`` against the
  threshold, on the voxels valid in the model with at least ``min_pts``
  points of each scan (the candidates);
* the solve: ``n_pre`` plain iterations, then ``n_post`` filtered ones,
  each a cold 6x6 eigensystem preceded by a fresh mask, as the program's
  in-loop phases are (``n_pre = max(min(dnn_start_iter, n_iters - 1),
  1)``).

Solving again a frame of a program under test, :func:`register` can follow
the program's keep flags: a bf16 rounding that moves a network shift near
the threshold flips a voxel's flag, and the solution after it moves as far
as a lower precision moves it.  So at each pass, where the program's flag
differs from the reference's and is the threshold rule applied to the
program's own shifts of that pass, its network's and its ICET shift (within
:data:`MARGIN`), the reference takes the program's flag; the program's
shifts are compared on their own.  A flag that differs and does not follow
from the program's shifts is a mismatch, and the reference keeps its own.

Departures, each deliberate:

* from upstream: the network is the repository's BiasNet (a PointNet-style
  encoder, max-pooled) and its bundled weights
  (``icet_tpu/models/weights/bias_net_s100.npz``, read with numpy), not
  upstream's KITTINet100, whose weights upstream does not ship; the
  sampled coordinates are rounded to bf16 before they are shifted and
  centred, as the program's samples are stored;
* from the program: the moment sums are icet.py's float64 one-hot
  products (:class:`icet.Precision`); LayerNorm takes flax's order, where
  the program's encoder kernel computes ``(a - mu) * (1 / sqrt(var +
  eps)) * scale + bias``; every float32 matrix product goes through a
  :class:`icet.Precision`, so that the control can round its operands to
  TF32.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import icet as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the encoder's stage widths and the head's
FEATURES = (64, 128, 256)
HEAD = (128, 64, 3)
IN_DIM = 4
LN_EPS = 1e-6
#: the bundled weights (flax's parameter names, each a float32 array)
WEIGHTS = (Path(__file__).resolve().parents[2] / "icet_tpu" / "models" / "weights"
           / "bias_net_s100.npz")
#: voxels a block of the network's evaluation
BLOCK = 256
#: metres either side of the threshold within which a program's flag
#: counts as the rule on its own shifts: the compact frame that the check
#: applies it in is the reference's, which differs from the program's by
#: float32 roundings (~1e-6 of a shift a few centimetres long)
MARGIN = 1e-4


class Filter(NamedTuple):
    """The filter's settings of a configuration."""

    start_iter: int
    thresh: float
    sample_pts: int
    refine_steps: int


def filter_of(config: dict) -> Filter:
    """The :class:`Filter` of a configuration file; raises ValueError where
    it asks for a path the reference lacks (the filter off, or one mask
    for all filtered iterations)."""
    if not config.get("dnn_filter") or not config.get("dnn_in_loop", True):
        raise ValueError("the reference implements only the in-loop DNN filter")
    return Filter(config["dnn_start_iter"], config["dnn_thresh"], config["dnn_sample_pts"],
                  config["dnn_refine_steps"])


def grid_of(config: dict) -> ref.Grid:
    """icet.py's :class:`~benchmark.reference.icet.Grid` of a filtered
    configuration."""
    return ref.grid_of(dict(config, dnn_filter=False))


def phases(g: ref.Grid, f: Filter) -> tuple[int, int]:
    """``(n_pre, n_post)``: the plain and the filtered iterations."""
    n_pre = max(min(f.start_iter, g.n_iters - 1), 1)
    return n_pre, g.n_iters - n_pre


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


def load_weights(path=WEIGHTS) -> dict:
    """Flax's parameter names -> float32 numpy arrays, from an ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def random_weights(seed: int, head_scale: float = 0.05) -> dict:
    """Seeded random weights under flax's parameter names: Dense kernels
    normal with variance ``1 / fan_in``, biases and LayerNorm parameters
    normal around 0 and 1 with deviation 0.1; the last layer scaled by
    ``head_scale``, so that the predicted shifts lie near the threshold."""
    rng = np.random.default_rng(seed)
    dims = (IN_DIM,) + FEATURES + HEAD
    out = {}
    for i, (c, f) in enumerate(zip(dims[:-1], dims[1:])):
        scale = head_scale if i == len(dims) - 2 else 1.0
        out[f"params/Dense_{i}/kernel"] = rng.normal(0.0, scale / np.sqrt(c), (c, f))
        out[f"params/Dense_{i}/bias"] = rng.normal(0.0, 0.1 * scale, f)
    for i, f in enumerate(FEATURES):
        out[f"params/LayerNorm_{i}/scale"] = rng.normal(1.0, 0.1, f)
        out[f"params/LayerNorm_{i}/bias"] = rng.normal(0.0, 0.1, f)
    return {k: v.astype(np.float32) for k, v in out.items()}


class Net(NamedTuple):
    """The network's tensors on one device: per encoder stage the kernel and
    bias rounded to bf16 (held as float32) and LayerNorm's scale and bias;
    per head layer its kernel and bias."""

    encoder: list
    head: list


def net_of(weights: dict, device) -> Net:
    def t(name, bf16=False):
        x = torch.from_numpy(np.asarray(weights[f"params/{name}"], np.float32)).to(device)
        return x.to(torch.bfloat16).float() if bf16 else x

    encoder = [(t(f"Dense_{i}/kernel", True), t(f"Dense_{i}/bias", True),
                t(f"LayerNorm_{i}/scale"), t(f"LayerNorm_{i}/bias"))
               for i in range(len(FEATURES))]
    head = [(t(f"Dense_{len(FEATURES) + j}/kernel"), t(f"Dense_{len(FEATURES) + j}/bias"))
            for j in range(len(HEAD))]
    return Net(encoder, head)


def encode(net: Net, x: torch.Tensor, p: ref.Precision = ref.FP32) -> torch.Tensor:
    """``(B, P, 4)`` float32 -> ``(B, 256)`` float32: the encoder and the max
    over the points."""
    bf16 = torch.bfloat16
    h = x.to(bf16).float()
    for w, b, scale, bias in net.encoder:
        # bf16 operands: every product is exact in float32, the sum float32.
        a = p.mm(h, w).to(bf16).float()
        a = (a + b).to(bf16).float()
        mu = a.mean(dim=-1, keepdim=True)
        var = torch.clamp((a * a).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (a - mu) * (torch.rsqrt(var + LN_EPS) * scale) + bias
        h = torch.relu(y.to(bf16)).float()
    return h.amax(dim=-2)


def apply_net(net: Net, x: torch.Tensor, p: ref.Precision = ref.FP32) -> torch.Tensor:
    """``(B, 2S, 4) -> (B, 3)``: the encoder in blocks of voxels, then the
    float32 head."""
    g = torch.cat([encode(net, x[i:i + BLOCK], p) for i in range(0, x.shape[0], BLOCK)])
    for j, (w, b) in enumerate(net.head):
        g = p.mm(g, w) + b
        if j < len(net.head) - 1:
            g = torch.relu(g)
    return g


def pack(sample1: torch.Tensor, sample2: torch.Tensor) -> torch.Tensor:
    """The network input of two ``(B, S, 3)`` samples: both centred on their
    joint mean, with the scan channel (-1 for scan 1, +1 for scan 2)."""
    both = torch.cat([sample1, sample2], dim=1)
    both = both - both.mean(dim=1, keepdim=True)
    s = sample1.shape[1]
    tag = torch.cat([torch.full((s,), -1.0), torch.full((sample2.shape[1],), 1.0)]).to(both)
    return torch.cat([both, tag.expand(both.shape[0], -1)[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# The filter
# ---------------------------------------------------------------------------


def head_samples(pts: torch.Tensor, bounds: torch.Tensor, g: ref.Grid, s: int) -> torch.Tensor:
    """``(V+1, S, 3)``: each voxel's first ``s`` member points of ``pts`` in
    scan order (a point is a member where its range is at least
    ``min_range`` and inside its voxel's radial bounds), their coordinates
    rounded to bf16, the rows past the voxel's count filled with its first
    point (zero rows where it has none)."""
    rtp = ref.cart_to_spherical(pts)
    r = rtp[..., 0]
    vid = ref.voxel_ids(rtp, g)
    member = ref.membership(vid, r, r >= g.min_range, bounds, g.n_voxels)
    vid = torch.where(member, vid, g.n_voxels).long()
    order = torch.argsort(vid, stable=True)
    vs = vid[order]
    counts = torch.bincount(vs, minlength=g.n_voxels + 1)
    rank = torch.arange(vs.shape[0], device=pts.device) - (torch.cumsum(counts, 0) - counts)[vs]
    take = (vs < g.n_voxels) & (rank < s)
    out = torch.zeros((g.n_voxels + 1, s, 3), dtype=pts.dtype, device=pts.device)
    out[vs[take], rank[take]] = pts[order[take]].to(torch.bfloat16).float()
    filled = torch.arange(s, device=pts.device)[None, :] < torch.clamp(counts, 1, s)[:, None]
    return torch.where(filled[..., None], out, out[:, :1])


class Pass(NamedTuple):
    """One filter pass: the keep mask, the network's shift, ICET's shift,
    the candidates and each voxel's compact frame ``U diag(l) U^T``; where
    it followed a program's flags (:func:`follow`), the flags it took from
    the program and those that differ without following from the
    program's shift."""

    keep: torch.Tensor
    dnn_shift: torch.Tensor
    icet_shift: torch.Tensor
    candidates: torch.Tensor
    compact: torch.Tensor
    adopted: torch.Tensor | None = None
    mismatched: torch.Tensor | None = None


def excess(compact: torch.Tensor, icet_shift: torch.Tensor,
           shift: torch.Tensor) -> torch.Tensor:
    """``(V+1,)``: the largest component of ``U diag(l) U^T (icet_shift -
    shift)``, which the rule holds against the threshold."""
    return torch.abs((compact * (icet_shift - shift)[:, None, :]).sum(dim=-1)).amax(dim=-1)


def filter_pass(net: Net, model: ref.Model, samples1: torch.Tensor, aligned: torch.Tensor,
                g: ref.Grid, f: Filter, p: ref.Precision = ref.FP32) -> Pass:
    """The mask of one pass: scan 2 aligned by the current solution against
    the model of scan 1, whose samples are given."""
    samples2 = head_samples(aligned, model.bounds, g, f.sample_pts)
    zero = torch.zeros(6, dtype=aligned.dtype, device=aligned.device)
    count2, mean2, _ = ref.finalize(
        ref.moment_sums(aligned, zero, model.bounds, model.anchors, g, p), model.anchors)
    icet_shift = mean2 - model.mean
    shift = torch.zeros_like(icet_shift)
    for _ in range(f.refine_steps):
        shift = shift + apply_net(net, pack(samples1 + shift[:, None, :], samples2), p)
    # U diag(l) U^T, the voxel's compact frame.
    compact = p.mm(model.basis * model.lmask[:, None, :], model.basis.transpose(1, 2))
    candidates = model.valid & (model.count >= g.min_pts) & (count2 >= g.min_pts)
    bad = candidates & (excess(compact, icet_shift, shift) > f.thresh)
    return Pass(~bad, shift, icet_shift, candidates, compact)


def follow(own: Pass, keep: torch.Tensor, shift: torch.Tensor, icet: torch.Tensor,
           thresh: float) -> Pass:
    """``own`` with the program's flags ``keep`` where they differ from its
    own and follow from the program's shifts (its network's ``shift`` and
    its ICET shift ``icet``) by the rule: a kept voxel no candidate or at
    most ``thresh + MARGIN`` out, a dropped one a candidate more than
    ``thresh - MARGIN`` out, in the reference's compact frame."""
    out = excess(own.compact, icet, shift)
    ruled = torch.where(keep, ~own.candidates | (out <= thresh + MARGIN),
                        own.candidates & (out > thresh - MARGIN))
    differ = keep != own.keep
    adopted = differ & ruled
    return own._replace(keep=torch.where(adopted, keep, own.keep), adopted=adopted,
                        mismatched=differ & ~ruled)


def register(model: ref.Model, samples1: torch.Tensor, scan: torch.Tensor, x0: torch.Tensor,
             g: ref.Grid, f: Filter, net: Net, p: ref.Precision = ref.FP32,
             program: tuple | None = None):
    """``(icet.Solve, [Pass])``: the plain phase from ``x0``, then each
    filtered iteration after a fresh pass at the current solution (a voxel
    the pass rejects is no correspondence), a cold 6x6 eigensystem each;
    the predicted stds from the last iteration's.  With ``program``, a
    solve under test's ``(keeps (P, V+1), dnn_shifts (P, V+1, 3),
    icet_shifts (P, V+1, 3))``, each pass :func:`follow` s the program's."""
    n_pre, n_post = phases(g, f)
    X = ref.register(model, scan, x0, g._replace(n_iters=n_pre), p).X
    passes = []
    for k in range(n_post):
        last = filter_pass(net, model, samples1, ref.transform_points(scan, X), g, f, p)
        if program is not None:
            last = follow(last, program[0][k], program[1][k], program[2][k], f.thresh)
        passes.append(last)
        masked = model._replace(valid=model.valid & last.keep)
        X, w6, keep, U2, _ = ref._iteration(masked, scan, X, g, None, p)
    return ref.Solve(X, ref._pred_stds(w6, U2, keep, g, p), n_pre + n_post), passes


def encoder_flop(rows: int, points: int) -> float:
    """Operations of one encoder evaluation over ``rows`` voxels of
    ``points`` points each: a multiply and an add per weight per point
    (the products of the three Dense stages)."""
    dims = (IN_DIM,) + FEATURES
    return 2.0 * rows * points * sum(c * f for c, f in zip(dims[:-1], dims[1:]))


def encoder_bytes(rows: int, points: int) -> float:
    """Bytes one encoder evaluation must move: its float32 input and codes,
    and the weights (kernels in bf16, the per-stage vectors in float32)."""
    dims = (IN_DIM,) + FEATURES
    weights = sum(2 * c * f + 3 * 4 * f for c, f in zip(dims[:-1], dims[1:]))
    return 4.0 * rows * (points * IN_DIM + FEATURES[-1]) + weights
