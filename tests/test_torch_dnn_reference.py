"""The port's DNN-filtered odometry against the benchmark's plain reference
(``benchmark/reference/dnn_filter.py``) on the CPU.

``OdometryPipeline`` with the filter in the loop (12 iterations, the last 5
filtered, 2 refinement passes) drives a short ``simulate_scan`` trajectory
at a small size: 48 beams x 512 azimuths against 49 azimuth bins (coprime,
so no column sits on a bin edge), 16 samples a scan a voxel.  It runs once
on seeded random BiasNet weights and once on the bundled s100 weights, each
given to the pipeline.  Every frame is solved again by the reference from
its two scans and the pipeline's previous solution, as the benchmark's
check does (the reference following the pipeline's keep flags where they
follow from its own shifts), and compared: X, the predicted stds, the
world pose, the network's shifts on the candidate voxels of every filter
pass and the keep flags that do not follow from the pipeline's shifts.
The same comparison fails with the reference's matrix products in TF32.  Unit cases hold the reference's sampling, packing and network
against the port's plain versions.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import dnn_filter as dref
from benchmark.reference import icet as ref
from icet_tpu_torch.config import ICETConfig, OdometryConfig
from icet_tpu_torch.convert import bias_net_params_from_numpy
from icet_tpu_torch.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch.filters import _unpack_fill_samples, model_voxel_samples
from icet_tpu_torch.models.bias_net import BiasNet, apply_bias_net, pack_voxel_samples
from icet_tpu_torch.odometry import OdometryPipeline
from icet_tpu_torch.ops.bias_encoder import encoder_pool_reference
from icet_tpu_torch.solver import prepare_reference

torch.set_num_threads(2)

CFG = ICETConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                 min_pts=20, min_range=1.0, n_iters=12, dnn_filter=True, dnn_start_iter=7,
                 dnn_thresh=0.05, dnn_sample_pts=16, dnn_refine_steps=2, dnn_in_loop=True)
CONFIG = dataclasses.asdict(CFG)
G, F = dref.grid_of(CONFIG), dref.filter_of(CONFIG)
FRAMES = 4
#: Tolerances, each with the readings of the random and the bundled
#: weights on this drive (in brackets; the reference in TF32 after the
#: semicolon), with room for other CPUs' float32 sums.  X and the pose: the
#: port sums moments in float32 in index order, the reference in float64,
#: so a solution moves by rounding alone.
X_ATOL = 2e-5  # (5.4e-7 / 1.2e-6; 2.2e-4 / 1.8e-5)
POSE_ATOL = 2e-5  # (5.4e-7 / 1.2e-6; 2.5e-4 / 2.5e-4)
#: the stds, relative: their smallest component is ~1e-3 of the largest
STD_RTOL = 1e-3  # (1.3e-5 / 7.2e-6; 0.019 / 2.0e-3)
#: the shifts, in metres, over every pass: the encoder rounds every stage
#: to bf16, and the two LayerNorm orders (the port's ``* (1 / sqrt) *
#: scale``, flax's ``* (rsqrt * scale)``) can round a feature one bf16 step
#: apart, which the max-pool and the head carry into that voxel's shift
SHIFT_ATOL = 1e-2  # (2.0e-4 / 2.4e-3; 4.4e-3 / 0.020)
#: keep flags, over every pass of every frame, that differ from the
#: reference's and do not follow from the pipeline's own shift by the
#: threshold rule: none
MASK_MISMATCHES = 0  # (0 / 0; 12 / 1)


def _scans():
    """``simulate_scan``'s scans of a drive at 0.2 m and 0.01 rad a frame."""
    src = SyntheticTrajectorySource(n_frames=FRAMES, speed=0.2, yaw_rate=0.01, n_beams=48,
                                    n_azimuth=512)
    return [np.asarray(s, np.float32) for s, _ in src]


def _nested(weights: dict) -> dict:
    tree: dict = {}
    for key, value in weights.items():
        d = tree
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return tree


def _port_net(weights: dict) -> BiasNet:
    net = BiasNet()
    net.load_state_dict(bias_net_params_from_numpy(_nested(weights)))
    return net.eval()


WEIGHTS = {"random": lambda: dref.random_weights(7), "s100": dref.load_weights}


@pytest.fixture(scope="module")
def scans():
    return _scans()


@functools.lru_cache(maxsize=None)
def _drive(name: str):
    """``(weights, frames)``: the pipeline's frames over the drive, on the
    weights ``name``."""
    weights = WEIGHTS[name]()
    pipe = OdometryPipeline(CFG, OdometryConfig(divergence_clamp=0.5), device="cpu",
                            net=_port_net(weights))
    return weights, [pipe.step(s) for s in _scans()]


def _reference(scans, frames, weights, p=ref.FP32):
    """Per frame ``(solve, pose, passes)`` of the reference, solved from the
    frame's scans and the pipeline's previous solution and pose, following
    the frame's keep flags."""
    net = dref.net_of(weights, "cpu")
    out = []
    for k in range(1, len(scans)):
        prev = frames[k - 1]
        x0 = torch.zeros(6) if prev is None else torch.from_numpy(prev.X)
        T0 = torch.eye(4) if prev is None else torch.from_numpy(prev.T_world)
        s1, s2 = torch.from_numpy(scans[k - 1]), torch.from_numpy(scans[k])
        model = ref.prepare(s1, G, p)
        samples1 = dref.head_samples(s1, model.bounds, G, F.sample_pts)
        filt = frames[k].dnn_filter
        sol, passes = dref.register(model, samples1, s2, x0, G, F, net, p,
                                    (filt.keeps, filt.dnn_shifts, filt.icet_shifts))
        out.append((sol, ref.compose_pose(T0, sol.X, p), passes))
    return out


def _gaps(scans, frames, weights, p=ref.FP32) -> dict:
    gaps = {"x": 0.0, "std": 0.0, "pose": 0.0, "shift": 0.0, "mask": 0, "adopted": 0}
    for frame, (sol, T, passes) in zip(frames[1:], _reference(scans, frames, weights, p)):
        assert frame.iterations == sol.iterations == CFG.n_iters and not frame.diverged
        gaps["x"] = max(gaps["x"], float(np.abs(frame.X - sol.X.numpy()).max()))
        gaps["std"] = max(gaps["std"], float(
            np.abs(frame.pred_stds / sol.pred_stds.numpy() - 1.0).max()))
        gaps["pose"] = max(gaps["pose"], float(np.abs(frame.T_world - T.numpy()).max()))
        assert len(passes) == frame.dnn_filter.keeps.shape[0] == 5
        for shift, q in zip(frame.dnn_filter.dnn_shifts, passes):
            gaps["shift"] = max(gaps["shift"],
                                float((shift - q.dnn_shift).abs()[q.candidates].max()))
            gaps["mask"] += int(q.mismatched.sum())
            gaps["adopted"] += int(q.adopted.sum())
    return gaps


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_drive_against_the_reference(scans, name):
    weights, frames = _drive(name)
    assert frames[0] is None and all(f is not None for f in frames[1:])
    # The filter does work on this drive: it keeps most voxels and drops some.
    for f in frames[1:]:
        assert 0 < f.n_rejected == int((~f.dnn_filter.keep).sum()) < f.dnn_filter.keep.numel() // 4
    gaps = _gaps(scans, frames, weights)
    assert gaps["x"] <= X_ATOL, gaps
    assert gaps["pose"] <= POSE_ATOL, gaps
    assert gaps["std"] <= STD_RTOL, gaps
    assert gaps["shift"] <= SHIFT_ATOL, gaps
    assert gaps["mask"] <= MASK_MISMATCHES, gaps


@pytest.mark.parametrize("fault", ["flag", "shift"])
def test_a_fault_in_one_pass_of_one_frame_is_seen(scans, fault):
    """In the second filter pass of one frame: a keep flag dropped on a
    candidate voxel well inside the threshold (the check counts it, and
    the reference keeps its own flag), or the network's shift moved by 5
    cm in one voxel (past the shifts' tolerance)."""
    weights, frames = _drive("random")
    frames = list(frames)
    filt = frames[2].dnn_filter
    q = _reference(scans, frames, weights)[1][2][1]
    inside = q.candidates & q.keep & (
        dref.excess(q.compact, q.icet_shift, filt.dnn_shifts[1]) < 0.5 * F.thresh)
    v = int(torch.nonzero(inside)[0])
    if fault == "flag":
        keeps = filt.keeps.clone()
        keeps[1, v] = False
        filt = filt._replace(keeps=keeps)
    else:
        shifts = filt.dnn_shifts.clone()
        shifts[1, v, 0] += 0.05
        filt = filt._replace(dnn_shifts=shifts)
    frames[2] = dataclasses.replace(frames[2], dnn_filter=filt)
    gaps = _gaps(scans, frames, weights)
    if fault == "flag":
        assert gaps["mask"] == 1, gaps
    else:
        assert gaps["shift"] > SHIFT_ATOL, gaps


def test_tf32_reference_fails_a_tolerance(scans):
    """The reference's matrix products with TF32 operands (ten mantissa
    bits) break at least one tolerance on the random weights' drive: the
    tolerances are tight enough to see a precision below float32."""
    weights, frames = _drive("random")
    gaps = _gaps(scans, frames, weights, ref.TF32)
    assert (gaps["x"] > X_ATOL or gaps["pose"] > POSE_ATOL or gaps["std"] > STD_RTOL
            or gaps["shift"] > SHIFT_ATOL or gaps["mask"] > MASK_MISMATCHES), gaps


@pytest.fixture(scope="module")
def model_and_scan(scans):
    scan = torch.from_numpy(scans[1])
    return prepare_reference(scan, CFG), scan


def test_head_samples_are_the_ports(model_and_scan):
    """The first S members of each voxel in scan order, in bf16, the tail
    filled with the voxel's first point: equal to the port's lean samples
    unpacked."""
    model, scan = model_and_scan
    lean, counts = model_voxel_samples(model, scan, CFG)
    want = _unpack_fill_samples(lean, counts)
    got = dref.head_samples(scan, model.bounds, G, F.sample_pts)
    assert got.dtype == want.dtype and got.shape == want.shape == (G.n_voxels + 1, 16, 3)
    assert torch.equal(got, want)
    assert int(counts.max()) == F.sample_pts and int((counts == 0).sum()) > 0


def test_pack_is_the_ports():
    g = torch.Generator().manual_seed(3)
    s1, s2 = torch.randn(7, 16, 3, generator=g) * 20, torch.randn(7, 16, 3, generator=g) * 20
    got, want = dref.pack(s1, s2), pack_voxel_samples(s1, s2)
    assert got.shape == (7, 32, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_network_against_the_ports_plain_version(weights):
    """The encoder's codes and the network's outputs on random voxel inputs:
    most codes equal; the rest a bf16 step apart (the LayerNorm order), so
    the outputs within the shifts' tolerance."""
    w = WEIGHTS[weights]()
    g = torch.Generator().manual_seed(5)
    x = torch.cat([torch.randn(64, 32, 3, generator=g) * 0.3,
                   torch.where(torch.arange(32) < 16, -1.0, 1.0)[None, :, None].expand(64, 32, 1)],
                  dim=-1)
    net, pnet = dref.net_of(w, "cpu"), _port_net(w)
    codes, want = dref.encode(net, x), encoder_pool_reference(x, pnet.encoder_weights())
    assert codes.shape == want.shape == (64, 256)
    same = torch.isclose(codes, want, rtol=0, atol=0).float().mean()
    assert same >= 0.99
    # one bf16 step of a code below 8 is at most 2**-5
    assert float((codes - want).abs().max()) <= 2.0 ** -5
    out, pout = dref.apply_net(net, x), apply_bias_net(pnet, x)
    assert out.shape == (64, 3)
    assert float((out - pout).abs().max()) <= SHIFT_ATOL


def test_reference_refuses_what_it_lacks():
    with pytest.raises(ValueError, match="in-loop"):
        dref.filter_of(dict(CONFIG, dnn_in_loop=False))
    with pytest.raises(ValueError, match="in-loop"):
        dref.filter_of(dict(CONFIG, dnn_filter=False))


def test_encoder_work_at_the_cells_size():
    """#4's bound counts 2.97e10 operations at 1,801 rows of 200 points."""
    assert dref.encoder_flop(1801, 200) == pytest.approx(2.969e10, rel=1e-3)


def test_follow_takes_only_flags_the_rule_gives():
    """Of four voxels whose flags the program and the reference disagree
    on, the reference takes the two that the threshold rule gives on the
    program's shift (one kept, one dropped) and counts the other two."""
    compact = torch.eye(3).expand(5, 3, 3)
    icet = torch.zeros(5, 3)
    own = dref.Pass(keep=torch.tensor([True, False, True, False, True]), dnn_shift=icet,
                    icet_shift=icet, candidates=torch.tensor([True] * 4 + [False]),
                    compact=compact)
    # the program's shifts: 0.06 and 0.04 m out in x, against 0.05
    shift = torch.tensor([[0.06, 0, 0], [0.04, 0, 0], [0.04, 0, 0], [0.06, 0, 0], [0.9, 0, 0]])
    keep = torch.tensor([False, True, False, True, True])
    out = dref.follow(own, keep, shift, icet, 0.05)
    assert out.adopted.tolist() == [True, True, False, False, False]
    assert out.mismatched.tolist() == [False, False, True, True, False]
    assert out.keep.tolist() == [False, True, True, False, True]
    # within MARGIN of the threshold either flag follows from the rule
    near = torch.tensor([[0.05 + dref.MARGIN / 2, 0, 0]] * 5)
    assert not dref.follow(own, ~own.keep, near, icet, 0.05).mismatched[:4].any()
