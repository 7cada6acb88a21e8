"""Kernel #6's plain version, its routing and its launch plan, on the CPU.

``gn_assembly`` takes ``gn_assembly_reference`` for CPU tensors, so here it
must give, in every branch (a correspondence mask, the moving-object test
before, at and after ``rm_start_iter``, the range sensitivity), the bits of
the chain ``solver.iteration_from_sums`` ran before the kernel: the
finalize, the mask, the moving test and ``assemble_normal_equations``,
written out below as it stood.  ``chip_smoke.py`` phase 31 (and
``test_torch_gn_assembly_card.py``) holds the CUDA kernel against the
plain version on the card.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from icet_tpu_torch import _build, graphs, solver
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch.ops import gn_assembly as gna
from icet_tpu_torch.ops.geometry import rotation_jacobian
from icet_tpu_torch.ops.moments import finalize_moments_planes
from icet_tpu_torch.ops.wls_planes import assemble_normal_equations, residual_compact_planes

torch.set_num_threads(2)

CFG = ICETConfig(n_theta=25, n_phi=9)
MOVING = CFG.replace(remove_moving=True, rm_start_iter=2)
X = torch.tensor([0.1, -0.05, 0.02, 0.01, -0.02, 0.03])


def _chain(model, sums, X, it, cfg, corr_mask=None, want_range_sens=False):
    """``iteration_from_sums``'s plane math before the kernel, verbatim."""
    count2, mean2, cov2 = finalize_moments_planes(sums, model.anchors)

    corr = model.valid & (count2 >= cfg.min_pts)
    if corr_mask is not None:
        corr = corr & corr_mask

    def yaw(cov):
        if cov.ndim == 2:
            return torch.atan2(-cov[:, 3], cov[:, 0])
        return torch.atan2(-cov[..., 0, 1], cov[..., 0, 0])

    n_rejected = torch.zeros((), dtype=torch.int32, device=X.device)
    if cfg.remove_moving and it >= cfg.rm_start_iter:
        res_compact = residual_compact_planes(model.basis, model.lmask, model.mean, mean2)
        bad_res = torch.any(torch.abs(res_compact) > cfg.rm_residual_thresh, dim=-1)
        yaw_delta = torch.abs(yaw(model.cov) - yaw(cov2))
        bad = corr & (bad_res | (yaw_delta > cfg.rm_yaw_thresh))
        n_rejected = torch.sum(bad, dtype=torch.int32)
        corr = corr & ~bad

    cm = corr.to(X.dtype)
    dR = rotation_jacobian(X[3:6])
    args = (model.basis, model.lmask, model.cov, model.count, cov2, count2,
            model.mean, mean2, dR, cm, cfg.pinv_rcond)
    htwg = None
    if want_range_sens:
        d3 = [mean2[:, j] - X[j] for j in range(3)]
        gn = torch.sqrt(torch.clamp(d3[0] ** 2 + d3[1] ** 2 + d3[2] ** 2, min=1e-12))
        HTWH, HTWdz, _, htwg = assemble_normal_equations(
            *args, extra_dz=[dj / gn for dj in d3]
        )
    else:
        HTWH, HTWdz, _ = assemble_normal_equations(*args)
    return corr, torch.sum(corr, dtype=torch.int32), n_rejected, HTWH, HTWdz, htwg


def _bits(t):
    return None if t is None else t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    return all((x is None and y is None) or (x is not None and y is not None
                                            and x.dtype == y.dtype and x.shape == y.shape
                                            and torch.equal(_bits(x), _bits(y)))
               for x, y in zip(a, b, strict=True))


@pytest.fixture(scope="module")
def pair():
    s1, s2 = scan_pair_with_ground_truth(np.array([0.3, -0.1, 0.05, 0.01, -0.01, 0.04]),
                                         seed=3, n_beams=16, n_azimuth=509)
    s1 = torch.from_numpy(np.asarray(s1, np.float32))
    s2 = torch.from_numpy(np.asarray(s2, np.float32))
    model = solver.prepare_reference(s1, CFG)
    sums = solver._sums(s2, X, model.bounds, model.anchors, CFG)
    mask = torch.rand(CFG.n_voxels + 1, generator=torch.Generator().manual_seed(1)) > 0.3
    return model, sums, mask


BRANCHES = {
    "plain": (CFG, 0, False, False),
    "mask": (CFG, 0, True, False),
    "moving before rm_start_iter": (MOVING, 1, False, False),
    "moving at rm_start_iter": (MOVING, 2, False, False),
    "moving after, masked": (MOVING, 3, True, False),
    "range sensitivity": (CFG, 0, False, True),
    "all": (MOVING, 2, True, True),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_bits_equal_the_plain_chain(pair, branch):
    model, sums, mask = pair
    cfg, it, masked, sens = BRANCHES[branch]
    m = mask if masked else None
    want = _chain(model, sums, X, it, cfg, m, sens)
    dR = rotation_jacobian(X[3:6])
    ref = gna.gn_assembly_reference(model, sums, X, dR, it, cfg, m, sens)
    before = gna.gn_assembly.launches
    got = gna.gn_assembly(model, sums, X, dR, it, cfg, m, sens)
    assert _same(ref, want) and _same(got, want)
    assert gna.gn_assembly.launches == before  # the CPU takes the plain version
    assert int(want[1]) > 0
    if cfg.remove_moving and it >= cfg.rm_start_iter:
        assert int(want[2]) > 0  # the moving test rejects something here
    assert (want[5] is None) == (not sens)


@pytest.mark.parametrize("branch", ["plain", "all"])
def test_iteration_from_sums_keeps_the_chain(pair, branch):
    """The solver's iteration hands the chain's mask, counts and normal
    equations on: its corr and diagnostics are the chain's."""
    model, sums, mask = pair
    cfg, it, masked, sens = BRANCHES[branch]
    m = mask if masked else None
    want = _chain(model, sums, X, it, cfg, m, sens)
    _, _, _, corr, _, diag, htwg = solver.iteration_from_sums(model, sums, X, it, cfg, m, None,
                                                              sens)
    assert torch.equal(corr, want[0])
    assert int(diag[0]) == int(want[1]) and int(diag[4]) == int(want[2])
    assert _same([htwg], [want[5]])


def test_cpu_routes_to_the_plain_version(pair, monkeypatch):
    model, sums, _ = pair
    calls = []
    real = gna.gn_assembly_reference

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(gna, "gn_assembly_reference", spy)
    gna.gn_assembly(model, sums, X, rotation_jacobian(X[3:6]), 0, CFG)
    assert len(calls) == 1


def test_other_devices_raise(pair):
    model, sums, _ = pair
    meta = type(model)(*(t.to("meta") for t in model))
    with pytest.raises(ValueError, match="no normal-equation kernel"):
        gna.gn_assembly(meta, sums.to("meta"), X.to("meta"), torch.empty(3, 3, 3, device="meta"),
                        0, CFG)


def test_check_rejects_dtype_shape_and_device(pair):
    model, sums, mask = pair
    dR = rotation_jacobian(X[3:6])
    gna._check(model, sums, X, dR, mask)  # the layout the kernel takes
    with pytest.raises(TypeError, match="sums"):
        gna._check(model, sums.double(), X, dR, None)
    with pytest.raises(TypeError, match="corr_mask"):
        gna._check(model, sums, X, dR, mask.float())
    with pytest.raises(ValueError, match="basis"):
        gna._check(model._replace(basis=model.basis.reshape(-1, 9)), sums, X, dR, None)
    with pytest.raises(ValueError, match="dR"):
        gna._check(model, sums, X, dR[0], None)
    with pytest.raises(ValueError, match="X is on meta"):
        gna._check(model, sums, X.to("meta"), dR, None)


@pytest.mark.parametrize("rows, blocks, threads", [
    (1_801, 29, 64),      # 75x24, the benchmark's grid
    (7_201, 113, 64),     # 150x48
    (90_001, 352, 256),   # fixed radial mode
])
def test_launch_plan(rows, blocks, threads):
    assert gna.launch_plan(rows) == (blocks, threads)
    assert (blocks - 1) * threads < rows <= blocks * threads
    assert threads % 32 == 0 and threads <= 256
    assert gna.scratch_words(blocks) == blocks * 35


def test_c_interface_matches_the_wrapper():
    """The C entry point's parameters, read from the source, are the
    wrapper's ctypes argument types in order (nothing here can compile it)."""
    src = (_build.CSRC / "gn_assembly.cu").read_text()
    params = re.search(r"int icet_gn_assembly\(([^)]*)\)", src).group(1)
    kinds = {"void*": "p", "int": "i", "float": "f"}
    got = []
    for p in params.split(","):
        words = p.replace("const", "").replace("*", "* ").split()
        got.append(kinds["".join(words[:-1])])
    want = {gna._P: "p", gna._I: "i", gna._F: "f"}
    assert "".join(got) == "".join(want[t] for t in gna.ARGTYPES)


def test_kernel_build_rules():
    """-fmad=false and no fast math; no float atomic in the source (the
    only atomics count blocks and integers)."""
    assert "-fmad=false" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS
    src = (_build.CSRC / "gn_assembly.cu").read_text()
    atomics = re.findall(r"atomicAdd\(([^,]+),", src)
    assert atomics and all(a.strip() in ("&g_ticket", "&s_counts[0]", "&s_counts[1]")
                           for a in atomics)
    assert gna.gn_assembly in graphs.COUNTED

